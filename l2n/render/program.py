"""Program layer: scene construction + compiled render step, bundled.

Mirrors the reference's render-program objects — `PathtracingProgram` (base
uniform plumbing, l2n-renderer/src/main.cpp:671-693), `SphereProgram`
(builds + uploads the sphere buffer, :695-712) and `TriangleProgram` (builds
the tessellated mesh buffers, :714-788). Here "uploading buffers and setting
bindless pointers" becomes: build the scene pytree and close a jitted render
step over it; "linking the kernel against an RNG module" (main.cpp:688) is
the `cfg.rng` choice baked into the step.
"""

from __future__ import annotations

from l2n.config import RenderConfig
from l2n.render.step import build_render_step, default_backend
from l2n.scene.spheres import SphereScene, compute_spheres
from l2n.scene.tessellate import TriangleScene, build_triangle_scene


class PathtracingProgram:
    """Base: owns the config, the scene, the compiled step and the
    material/light buffers. The reference DECLARES and binds these buffers
    (src/main.cpp:675-693) but never reads them; here they are LIVE
    (ops/lights.py): point/directional lights add deterministic direct
    lighting at diffuse vertices and PhongMaterials.diffuse overrides the
    procedural per-object albedo. Empty buffers (the default — the
    reference's own state) compile the identical program."""

    name = "basePT"

    def __init__(self, cfg: RenderConfig, scene, backend: str = "auto",
                 materials=None, point_lights=None, directional_lights=None,
                 steps_per_call: int = 1, interpret: bool = False):
        if backend == "auto":
            backend = default_backend(cfg)
        self.cfg = cfg.validate()
        self.scene = scene
        self.backend = backend
        from l2n.scene.materials import empty_lights
        default_mats, default_pl, default_dl = empty_lights()
        self.materials = materials if materials is not None else default_mats
        self.point_lights = (point_lights if point_lights is not None
                             else default_pl)
        self.directional_lights = (directional_lights
                                   if directional_lights is not None
                                   else default_dl)
        # steps_per_call > 1 fuses N scheduler steps into one jitted call
        # (lax.fori_loop threading the frame state): the image after a call
        # is identical to N single steps, but host->device dispatch is paid
        # once per call. Throughput mode for headless rendering.
        self.steps_per_call = steps_per_call
        from l2n.ops.lights import ExplicitLights
        lights = ExplicitLights(self.materials, self.point_lights,
                                self.directional_lights)
        self.step = build_render_step(
            cfg, scene, backend=backend, steps_per_call=steps_per_call,
            lights=lights if lights.enabled else None, interpret=interpret)

    def __repr__(self) -> str:  # pragma: no cover
        return f"<{type(self).__name__} backend={self.backend} cfg={self.cfg}>"


class SphereProgram(PathtracingProgram):
    """Analytic 128-sphere scene (SphereProgram, main.cpp:695-712)."""

    name = "spherePT"

    def __init__(self, cfg: RenderConfig, scene: SphereScene | None = None,
                 backend: str = "auto", **kw):
        cfg = cfg.replace(scene_kind="sphere")
        if scene is None:
            scene = compute_spheres(cfg.sphere_count, cfg.world_size,
                                    cfg.scene_seed)
        super().__init__(cfg, scene, backend, **kw)


class TriangleProgram(PathtracingProgram):
    """Tessellated-mesh scene (TriangleProgram, main.cpp:714-788): the same
    procedural spheres tessellated at (disc_lat, disc_long)."""

    name = "trianglePT"

    def __init__(self, cfg: RenderConfig, scene: TriangleScene | None = None,
                 backend: str = "auto", **kw):
        cfg = cfg.replace(scene_kind="triangle")
        if scene is None:
            if cfg.obj_path:
                from l2n.scene.obj import load_obj
                scene = load_obj(cfg.obj_path)
            else:
                spheres = compute_spheres(cfg.sphere_count, cfg.world_size,
                                          cfg.scene_seed)
                scene = build_triangle_scene(spheres, cfg.disc_lat,
                                             cfg.disc_long)
        super().__init__(cfg, scene, backend, **kw)
