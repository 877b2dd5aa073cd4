"""Explicit point/directional lights + per-object material overrides.

The reference DECLARES Phong materials, point lights and directional
lights and binds std430 buffers for them (`PhongMaterial`/`PointLight`/
`DirectionalLight`, l2n-renderer/src/shaders/sphere_pathtracing.cs.glsl
:9-38, buffers :52-69) — but its shading never reads them and their counts
stay zero (l2n-renderer/src/main.cpp:675-693). The containers
(scene/materials.py) used to be an inert parity mirror; this module makes
the declared surface LIVE (r3 VERDICT item 9):

* `PointLights` / `DirectionalLights` passed to a program become real
  light sources: a deterministic direct-lighting term at every diffuse
  surface vertex. They are DIRAC lights — BSDF sampling hits them with
  probability zero — so they need no MIS bookkeeping, cannot double-count
  against NEE (which samples the emissive GEOMETRY), and consume NO RNG
  draws: stream layouts (and therefore every bit-parity gate) are
  untouched. Radiometry:
    point:        Lo = f(wi) * I * cos(theta) / d^2     [I = radiantIntensity]
    directional:  Lo = f(wi) * E * cos(theta)           [E = emittedRadiance,
                                                         wi = -incidentDirection]
  Each light casts one shadow ray through the scene's full nearest-hit
  sweep. Under homogeneous fog the segment carries the analytic
  Beer-Lambert transmittance (exp(-sigma*d); directional lights traverse
  the finite sky shell, like the environment).

* `PhongMaterials.diffuse.rgb` overrides the procedural per-object albedo
  hash (glsl:215-222): object index i uses material i when i < count and
  keeps the procedural hash otherwise. The reference defines no semantics
  for its (always-empty) buffers, so index-keyed assignment — the natural
  reading of its per-object arrays — is chosen and documented here. The
  remaining channels (alpha, glossy, shininess) stay carried-but-unread,
  exactly as declared.

Everything is lane-lockstep: light parameters are HOST scalars closed over
at trace time (a handful of constants per light), and the albedo override
is a select-sweep — no per-lane gathers, so the identical code runs in the
XLA oracle and inside Pallas kernel bodies.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from l2n.maths.sampling import PI, normalize3


class ExplicitLights:
    """Trace-time bundle of the live material/light data.

    Built from the scene/materials.py containers (or raw arrays); holds
    host-side numpy so kernel tracing bakes the values in as constants.
    """

    def __init__(self, materials=None, point_lights=None,
                 directional_lights=None):
        def host(container, names):
            if container is None:
                return np.zeros((0, len(names)), np.float32)
            cols = [getattr(container, n) for n in names]
            if cols[0].shape[0] == 0:
                # Empty containers (the reference's default state) must not
                # touch the device: np.asarray on a jnp field would be a
                # device-to-host readback for nothing.
                return np.zeros((0, len(names)), np.float32)
            return np.stack([np.asarray(c, np.float32) for c in cols],
                            axis=1)

        self.albedo = host(materials, ("diffuse_r", "diffuse_g", "diffuse_b"))
        self.point = host(point_lights, ("x", "y", "z", "intensity_r",
                                         "intensity_g", "intensity_b"))
        dl = host(directional_lights,
                  ("dir_x", "dir_y", "dir_z", "radiance_r", "radiance_g",
                   "radiance_b"))
        # Precompute wi = -normalize(incidentDirection) on the host.
        if dl.shape[0]:
            n = np.linalg.norm(dl[:, :3], axis=1, keepdims=True)
            dl = dl.copy()
            dl[:, :3] = -dl[:, :3] / np.maximum(n, 1e-20)
        self.directional = dl

    @property
    def enabled(self) -> bool:
        """True when any component changes the render (trace-time gate:
        empty containers compile to the identical program)."""
        return bool(self.point.shape[0] or self.directional.shape[0]
                    or self.albedo.shape[0])

    @property
    def has_lights(self) -> bool:
        return bool(self.point.shape[0] or self.directional.shape[0])

    def override_albedo(self, index, kd_r, kd_g, kd_b):
        """Select-sweep the material table over the per-lane object index
        (index-keyed semantics, see module docstring)."""
        f32 = jnp.float32
        for i in range(self.albedo.shape[0]):
            m = index == i
            kd_r = jnp.where(m, f32(float(self.albedo[i, 0])), kd_r)
            kd_g = jnp.where(m, f32(float(self.albedo[i, 1])), kd_g)
            kd_b = jnp.where(m, f32(float(self.albedo[i, 2])), kd_b)
        return kd_r, kd_g, kd_b


def explicit_light_contribution(cfg, lights: ExplicitLights, intersect,
                                hx, hy, hz, nx, ny, nz,
                                kd_r, kd_g, kd_b, tp_r, tp_g, tp_b,
                                brdf_eval=None):
    """Direct radiance from every explicit light at the vertex (h, n) with
    throughput tp (see module docstring for the estimator). `brdf_eval`
    overrides the Lambert kd/pi (microfacet / disney material modes).
    Deterministic: no sampler draws. Returns (r, g, b)."""
    f32 = jnp.float32
    nhx, nhy, nhz = normalize3(nx, ny, nz)
    eps = f32(cfg.ray_epsilon)
    sigma = float(cfg.fog_density)
    zero = jnp.zeros(jnp.broadcast_shapes(jnp.shape(hx), jnp.shape(nx)),
                     jnp.float32)
    out_r = out_g = out_b = zero

    def eval_f(lx, ly, lz):
        if brdf_eval is None:
            return (kd_r * f32(1.0 / PI), kd_g * f32(1.0 / PI),
                    kd_b * f32(1.0 / PI))
        f_r, f_g, f_b, _ = brdf_eval(lx, ly, lz)
        return f_r, f_g, f_b

    for i in range(lights.point.shape[0]):
        px, py, pz, ir, ig, ib = (float(v) for v in lights.point[i])
        lx, ly, lz = f32(px) - hx, f32(py) - hy, f32(pz) - hz
        d2 = lx * lx + ly * ly + lz * lz
        dist = jnp.sqrt(jnp.maximum(d2, f32(1e-20)))
        rcp = jax.lax.rsqrt(jnp.maximum(d2, f32(1e-20)))  # = 1/dist (normalize3)
        lx, ly, lz = lx * rcp, ly * rcp, lz * rcp
        cos_s = jnp.maximum(nhx * lx + nhy * ly + nhz * lz, f32(0.0))
        sh = intersect(hx + eps * lx, hy + eps * ly, hz + eps * lz,
                       lx, ly, lz)
        # Visible iff nothing sits between the vertex and the light POINT
        # (a hit beyond it does not occlude; 2*eps absorbs the origin
        # offset at the near end).
        visible = (sh.t < 0.0) | (sh.t >= dist - f32(2.0) * eps)
        w = cos_s / jnp.maximum(d2, f32(1e-20))
        if sigma > 0.0:
            w = w * jnp.exp(f32(-sigma) * dist)
        w = jnp.where(visible, w, f32(0.0))
        f_r, f_g, f_b = eval_f(lx, ly, lz)
        out_r = out_r + f_r * f32(ir) * w
        out_g = out_g + f_g * f32(ig) * w
        out_b = out_b + f_b * f32(ib) * w

    if lights.directional.shape[0] and sigma > 0.0:
        from l2n.ops.pathtrace import _fog_sky
        dir_transmit = float(np.exp(-sigma * _fog_sky(cfg)))
    else:
        dir_transmit = 1.0
    for i in range(lights.directional.shape[0]):
        wx, wy, wz, er, eg, eb = (float(v) for v in lights.directional[i])
        cos_s = jnp.maximum(nhx * f32(wx) + nhy * f32(wy) + nhz * f32(wz),
                            f32(0.0))
        sh = intersect(hx + eps * f32(wx), hy + eps * f32(wy),
                       hz + eps * f32(wz),
                       jnp.broadcast_to(f32(wx), jnp.shape(zero)),
                       jnp.broadcast_to(f32(wy), jnp.shape(zero)),
                       jnp.broadcast_to(f32(wz), jnp.shape(zero)))
        visible = sh.t < 0.0
        w = jnp.where(visible, cos_s * f32(dir_transmit), f32(0.0))
        f_r, f_g, f_b = eval_f(f32(wx), f32(wy), f32(wz))
        out_r = out_r + f_r * f32(er) * w
        out_g = out_g + f_g * f32(eg) * w
        out_b = out_b + f_b * f32(eb) * w

    return tp_r * out_r, tp_g * out_g, tp_b * out_b
