"""The application: camera persistence + programs + frame loop.

Structural port of `l2n::Application::run` (l2n-renderer/src/main.cpp:
790-1015): load the cached camera pose, build both render programs, then
per frame — render step, present, apply controller input, clear
accumulation on camera move — and save the pose on exit. Input arrives as
`ControllerInput` records (scripted, replayed, or wired to a UI) instead of
GLFW polls.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Callable, Iterable

from l2n.camera import Camera, ControllerInput, ViewController
from l2n.camera.cache import load_view_matrix, save_view_matrix
from l2n.config import RenderConfig
from l2n.render.program import SphereProgram, TriangleProgram
from l2n.render.renderer import Renderer
from l2n.utils.profiling import log_metrics

_log = logging.getLogger("l2n.app")

InputSource = Callable[[int], ControllerInput | None]


class Application:
    def __init__(self, cfg: RenderConfig | None = None,
                 workdir: str | Path = ".", backend: str = "auto",
                 renderer_names: Iterable[str] = ("spherePT", "trianglePT"),
                 initial_renderer: str | None = None,
                 triangle_scene=None, interpret: bool = False):
        """`triangle_scene` overrides the procedural tessellation for the
        trianglePT renderer — e.g. an OBJ file via scene.obj.load_obj.
        `interpret=True` runs the kernel in the Pallas interpreter (tests
        on CPU)."""
        self.cfg = (cfg or RenderConfig()).validate()
        self.workdir = Path(workdir)

        programs = {}
        if "spherePT" in renderer_names:
            programs["spherePT"] = SphereProgram(self.cfg, backend=backend,
                                                 interpret=interpret)
        if "trianglePT" in renderer_names:
            programs["trianglePT"] = TriangleProgram(
                self.cfg, scene=triangle_scene, backend=backend,
                interpret=interpret)
        # The reference starts on the triangle renderer (rendererIndex = 1,
        # main.cpp:899) — default to the sphere PT here (the flagship), but
        # keep it selectable.
        self.renderer = Renderer(programs, initial_renderer)

        view = load_view_matrix(self.workdir)
        # Camera speed = worldSize / 10 (main.cpp:820).
        self.controller = ViewController(speed=self.cfg.world_size / 10.0,
                                         view_matrix=view)

    @property
    def camera(self) -> Camera:
        return Camera.from_config(self.cfg, self.controller.view_matrix)

    def switch_renderer(self, name: str) -> None:
        self.renderer.switch(name)

    def run(self, frames: int, display=None,
            input_source: InputSource | None = None,
            metrics_every: int = 0, save_camera: bool = True):
        """Render `frames` progressive steps (the while-loop at
        main.cpp:951-1002, bounded instead of window-close-driven)."""
        import time
        last = time.perf_counter()
        try:
            for frame in range(frames):
                self.renderer.step(self.camera)
                if display is not None:
                    display.present(self.renderer.display(), frame)
                if metrics_every and (frame + 1) % metrics_every == 0:
                    log_metrics(frame + 1, self.renderer.metrics())

                now = time.perf_counter()
                dt, last = now - last, now
                inp = input_source(frame) if input_source else None
                if inp is not None and self.controller.update(inp, dt):
                    # hasMoved => clear accumulation (main.cpp:999-1001).
                    self.renderer.on_camera_moved()
        finally:
            if display is not None:
                display.close()
            if save_camera:
                save_view_matrix(self.controller.view_matrix, self.workdir)
        return self.renderer.state

    # -- session checkpoints (beyond the reference's camera-only cache) ----
    def save_session(self, path: str | Path) -> Path:
        from l2n.utils.checkpoint import save_session
        return save_session(path, self.cfg, self.renderer.state,
                            self.controller.view_matrix)

    def load_session(self, path: str | Path) -> None:
        from l2n.utils.checkpoint import load_session
        cfg, state, view = load_session(path)
        if cfg != self.cfg:
            raise ValueError("session config does not match application config")
        self.renderer.state = state
        self.controller.set_view_matrix(view)


def main(argv: list[str] | None = None) -> int:  # pragma: no cover
    """CLI: headless render to a PNG sequence."""
    import argparse

    from l2n.app.display import AnsiDisplay, PngSequenceDisplay

    p = argparse.ArgumentParser(description="l2n progressive renderer")
    p.add_argument("--config", type=Path, help="RenderConfig JSON file")
    p.add_argument("--frames", type=int, default=256)
    p.add_argument("--out", type=Path, default=Path("frames"))
    p.add_argument("--every", type=int, default=16, help="PNG every N frames")
    p.add_argument("--renderer", default=None,
                   choices=["spherePT", "trianglePT"])
    p.add_argument("--obj", type=Path, default=None,
                   help="render this OBJ file with the triangle renderer")
    p.add_argument("--demo-scene", default=None,
                   choices=["torus-field", "trefoil"],
                   help="procedurally generated OBJ demo scene "
                        "(scene.procgen): the 24-tori field or the "
                        "70k-triangle trefoil knot")
    p.add_argument("--ansi", action="store_true", help="terminal preview")
    p.add_argument("--backend", default="auto")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    cfg = (RenderConfig.from_json(args.config.read_text())
           if args.config else RenderConfig())
    triangle_scene = None
    renderer = args.renderer
    renderer_names = ("spherePT", "trianglePT")
    if args.demo_scene is not None:
        if args.obj is not None:
            p.error("--demo-scene and --obj are mutually exclusive")
        from l2n.scene.obj import load_obj
        from l2n.scene.procgen import torus_field_obj, trefoil_obj
        gen = {"torus-field": torus_field_obj, "trefoil": trefoil_obj}
        triangle_scene = load_obj(gen[args.demo_scene]())
        renderer = "trianglePT"
        renderer_names = ("trianglePT",)
        cfg = cfg.replace(scene_kind="triangle")
    if args.obj is not None:
        renderer = "trianglePT"
        renderer_names = ("trianglePT",)
        # obj_path rides in the config (TriangleProgram loads it) so
        # session checkpoints record the scene source.
        cfg = cfg.replace(scene_kind="triangle", obj_path=str(args.obj))
    app = Application(cfg, backend=args.backend,
                      renderer_names=renderer_names,
                      initial_renderer=renderer,
                      triangle_scene=triangle_scene)
    display = (AnsiDisplay() if args.ansi
               else PngSequenceDisplay(args.out, every=args.every))
    app.run(args.frames, display=display, metrics_every=32)
    print(f"rendered {args.frames} steps; metrics: {app.renderer.metrics()}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
