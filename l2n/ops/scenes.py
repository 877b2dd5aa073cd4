"""Scene-specific intersect closures producing resolved `Hit` records.

These adapt the generic sweeps in `l2n.ops.intersect` to the `Hit`
contract of the path tracer — the analog of the reference's per-scene
`intersectScene` overloads (sphere_pathtracing.cs.glsl:199-213,
triangle_pathtracing.cs.glsl:156-191).
"""

from __future__ import annotations

import jax.numpy as jnp

from l2n.ops.intersect import (
    intersect_sphere_scene,
    intersect_triangle_scene,
    sphere_scene_anyhit,
)
from l2n.ops.pathtrace import Hit, IntersectFn
from l2n.scene.spheres import SphereScene


def sphere_intersector(scene: SphereScene, unroll: int = 1,
                       fast_math: bool = False) -> IntersectFn:
    """Oracle-side sphere intersector. Scene buffers are host numpy (see
    SphereScene); lift once here so traced-index fetches work."""
    cx, cy, cz, r2 = (jnp.asarray(scene.center_x), jnp.asarray(scene.center_y),
                      jnp.asarray(scene.center_z), jnp.asarray(scene.sqr_radius))
    n = scene.count

    def fetch(i):
        return cx[i], cy[i], cz[i], r2[i]

    def intersect(ox, oy, oz, dx, dy, dz) -> Hit:
        t, px, py, pz, nx, ny, nz, idx, br2 = intersect_sphere_scene(
            ox, oy, oz, dx, dy, dz, n, fetch, unroll=unroll,
            fast_math=fast_math)
        return Hit(t=t, px=px, py=py, pz=pz, nx=nx, ny=ny, nz=nz,
                   index=idx, emis_r2=br2)

    return intersect


def sphere_anyhit(scene: SphereScene, unroll: int = 1):
    """Oracle-side boolean any-hit sweep (last-segment env test)."""
    cx, cy, cz, r2 = (jnp.asarray(scene.center_x), jnp.asarray(scene.center_y),
                      jnp.asarray(scene.center_z), jnp.asarray(scene.sqr_radius))
    n = scene.count

    def fetch(i):
        return cx[i], cy[i], cz[i], r2[i]

    def anyhit(ox, oy, oz, dx, dy, dz):
        return sphere_scene_anyhit(ox, oy, oz, dx, dy, dz, n, fetch,
                                   unroll=unroll)

    return anyhit


def triangle_intersector(soup: dict[str, jnp.ndarray],
                         unroll: int = 1,
                         bound_r2: jnp.ndarray | None = None) -> IntersectFn:
    """Oracle-side triangle intersector over a flattened soup.

    Attributes of the winning triangle are gathered once per ray and
    barycentrically interpolated — normal = u*nb + v*nc + (1-u-v)*na
    (triangle_pathtracing.cs.glsl:186-187). The reference does NOT
    renormalize the interpolated normal; neither do we (parity).

    `emis_r2` is the constant 1.0 the reference substitutes for meshes
    (triangle_pathtracing.cs.glsl:268).
    """
    soup = {k: jnp.asarray(v) for k, v in soup.items()}  # host soup -> device
    if bound_r2 is not None:
        bound_r2 = jnp.asarray(bound_r2)
    total = soup["v1x"].shape[0]

    def fetch(i):
        return (soup["v1x"][i], soup["v1y"][i], soup["v1z"][i],
                soup["e1x"][i], soup["e1y"][i], soup["e1z"][i],
                soup["e2x"][i], soup["e2y"][i], soup["e2z"][i],
                soup["mesh_id"][i])

    def intersect(ox, oy, oz, dx, dy, dz) -> Hit:
        t, u, v, tri, mesh = intersect_triangle_scene(
            ox, oy, oz, dx, dy, dz, total, fetch, unroll=unroll)
        safe = jnp.maximum(tri, 0)
        w = jnp.float32(1.0) - u - v
        nx = u * soup["nbx"][safe] + v * soup["ncx"][safe] + w * soup["nax"][safe]
        ny = u * soup["nby"][safe] + v * soup["ncy"][safe] + w * soup["nay"][safe]
        nz = u * soup["nbz"][safe] + v * soup["ncz"][safe] + w * soup["naz"][safe]
        tc_u = u * soup["tbu"][safe] + v * soup["tcu"][safe] + w * soup["tau"][safe]
        tc_v = u * soup["tbv"][safe] + v * soup["tcv"][safe] + w * soup["tav"][safe]

        px = ox + t * dx
        py = oy + t * dy
        pz = oz + t * dz
        br2 = (bound_r2[jnp.maximum(mesh, 0)]
               if bound_r2 is not None else None)
        return Hit(t=t, px=px, py=py, pz=pz, nx=nx, ny=ny, nz=nz,
                   index=mesh, emis_r2=jnp.ones_like(t),
                   tc_u=tc_u, tc_v=tc_v, b_u=u, b_v=v, bound_r2=br2)

    return intersect
