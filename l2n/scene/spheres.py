"""Procedural analytic-sphere scene.

Analog of the reference's `Sphere` struct + `computeSpheres`
(l2n-renderer/src/main.cpp:177-187, 656-669): 128 spheres with centers
uniform in the ±worldSize/2 cube and radii up to 5% of worldSize. The
reference's array-of-32-byte-structs becomes a structure-of-arrays —
(cx, cy, cz, sqr_radius) component vectors — each component is one scalar
load that broadcasts against a whole pixel block.

The reference seeds its `c2ba::RandomGenerator` implicitly; here the
generator is an explicit fixed-seed numpy PCG64 so scenes are reproducible
and configurable (same distribution, documented deviation in exact values —
the reference's generator lives in a submodule not present in its snapshot).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SphereScene:
    """SoA sphere scene. Shapes: all (sphere_count,) float32.

    `sqr_radius` (not radius) is stored, matching the reference's
    precomputation (`Sphere::sqrRadius`, src/main.cpp:180,185).

    Constructors store HOST numpy arrays: scene packing and digesting are
    host-side work, and every device->host pull is a synchronizing
    transfer. Traced
    consumers lift to the device once (jnp.asarray at closure build /
    trace time); jnp-leaved instances (tests build them) work too.
    """

    center_x: jnp.ndarray
    center_y: jnp.ndarray
    center_z: jnp.ndarray
    sqr_radius: jnp.ndarray

    @property
    def count(self) -> int:
        return self.center_x.shape[0]

    def as_numpy(self) -> np.ndarray:
        """(N, 4) float32 [cx, cy, cz, sqrRadius] — native-renderer interface."""
        return np.stack(
            [np.asarray(self.center_x), np.asarray(self.center_y),
             np.asarray(self.center_z), np.asarray(self.sqr_radius)], axis=1
        ).astype(np.float32)


def spheres_disjoint(scene: SphereScene, margin: float = 0.0) -> bool:
    """True iff no two spheres overlap (pairwise center distance exceeds
    the radius sum by at least `margin`).

    Gates the t1-only intersection sweeps (`assume_outside` in
    ops.intersect): in a disjoint scene every bounce/shadow-ray origin —
    a hit point on some sphere's surface plus the ray epsilon — lies
    OUTSIDE every sphere, so the reference's inside-the-sphere t2
    fallback (sphere_pathtracing.cs.glsl:157-161) is dead and dropping
    it changes nothing (up to the fp-grazing corner documented in
    intersect_sphere_scene). Pass margin >= ray_epsilon so the
    epsilon-offset origins stay outside too. The reference's default
    procedural scene does NOT qualify (7 overlapping pairs at seed 0), so
    the fast path auto-enables only for scenes that do.
    """
    c = np.stack([np.asarray(scene.center_x), np.asarray(scene.center_y),
                  np.asarray(scene.center_z)], axis=1).astype(np.float64)
    r = np.sqrt(np.asarray(scene.sqr_radius, np.float64))
    d = np.sqrt(((c[:, None, :] - c[None, :, :]) ** 2).sum(-1))
    lim = r[:, None] + r[None, :] + margin
    np.fill_diagonal(d, np.inf)
    return bool((d > lim).all())


def compute_spheres(
    sphere_count: int = 128, world_size: float = 1024.0, seed: int = 0
) -> SphereScene:
    """Generate the procedural scene (computeSpheres, src/main.cpp:659-669):
    center ~ U(-worldSize/2, worldSize/2)^3, radius ~ U(0, 0.05 * worldSize).
    """
    gen = np.random.Generator(np.random.PCG64(seed))
    # Draw in the reference's order: (cx, cy, cz, radius) per sphere.
    u = gen.random((sphere_count, 4), dtype=np.float32)
    centers = (-0.5 * world_size + world_size * u[:, :3]).astype(np.float32)
    radii = (0.05 * world_size * u[:, 3]).astype(np.float32)
    return SphereScene(
        center_x=np.ascontiguousarray(centers[:, 0]),
        center_y=np.ascontiguousarray(centers[:, 1]),
        center_z=np.ascontiguousarray(centers[:, 2]),
        sqr_radius=np.ascontiguousarray(radii * radii),
    )
