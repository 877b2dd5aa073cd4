"""Ray/scene intersection in lane-lockstep SoA form.

The reference's divergent per-thread linear scans
(`intersectScene` l2n-renderer/src/shaders/sphere_pathtracing.cs.glsl:185-213,
`intersectTriangle`+mesh loop triangle_pathtracing.cs.glsl:111-191) become
`lax.fori_loop`s over primitives carrying a running nearest-hit, with every
comparison a lane-wise select. Primitive data is fetched through a `fetch(i)`
callback so the identical loop body reads jnp arrays in the oracle and
scalar loads from device memory inside the Pallas kernel.

Miss sentinel: t = -1.0, primitive index = -1 — exactly the reference's
convention (currentDist starts at -1, sphereIndex at -1; glsl:186,200-201).
Triangle scenes use +INF internally (glsl:9,158) but are normalized to the
same -1 convention at this boundary so the path tracer is scene-agnostic.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

# fast_sqrt(x) = x * rsqrt(x): in the sweeps below an x == 0 exact-tangent
# candidate poisons itself to a NaN miss — a measure-zero event of the
# statistical parity class.
from l2n.maths.sampling import fast_sqrt

# A fetch callback returns a tuple of scalar (or broadcastable) components
# for primitive i.
Fetch = Callable[[jnp.ndarray], tuple]

MOLLER_TRUMBORE_EPS = 1e-6  # EPSILON, triangle_pathtracing.cs.glsl:10



def intersect_sphere_scene(
    ox, oy, oz, dx, dy, dz, sphere_count, fetch: Fetch,
    unroll: int = 1, index_map=None, assume_outside: bool = False,
    fast_math: bool = False,
):
    """Nearest hit against `sphere_count` spheres.

    fetch(i) -> (cx, cy, cz, sqr_radius).

    Per-sphere math mirrors `intersectSphere` (sphere_pathtracing.cs.glsl:
    145-163) in half-b form (hb = b/2, quarter discriminant): t = t1 if
    t1 >= 0 else t2 (so a ray starting inside a sphere hits its backside);
    a candidate wins when t >= 0 and t < best (glsl:190,205) — internally
    "no hit" is +BIG so the winner test is one compare; the boundary
    converts back to the reference's -1 sentinel.

    `assume_outside=True` asserts every ray origin lies OUTSIDE every
    sphere (c > 0). Then both roots share c's sign, so t1 < 0 implies
    t2 < 0 and the reference's t2 fallback can never win. Used for
    bounce/shadow rays in disjoint-sphere scenes (origins sit on a
    sphere's surface plus an epsilon that no other sphere reaches — see
    spheres_disjoint). Exact up to one fp corner: a hit point can ROUND
    to marginally inside its own sphere, and a near-tangent secondary ray
    (grazing NEE/cosine samples, P ~ 1e-5) then keeps c < 0 for that
    sphere — the reference self-occludes via t2 where this sweep does
    not. Isolated-lane divergence of the statistical parity class.

    Returns (t, px, py, pz, nx, ny, nz, index, sqr_radius) — index is int32,
    -1 on miss; position/normal/sqr_radius are for the winning sphere (the
    emissive term needs the winner's r^2, glsl:286).
    """
    shape = jnp.broadcast_shapes(jnp.shape(ox), jnp.shape(dx))
    f32 = jnp.float32
    big = f32(3.0e38)
    best_t = jnp.full(shape, big, f32)
    best_i = jnp.full(shape, -1, jnp.int32)
    best_cx = jnp.zeros(shape, f32)
    best_cy = jnp.zeros(shape, f32)
    best_cz = jnp.zeros(shape, f32)
    best_r2 = jnp.ones(shape, f32)

    def body(i, carry):
        best_t, best_i, bcx, bcy, bcz, br2 = carry
        cx, cy, cz, r2 = fetch(i)
        rox, roy, roz = ox - cx, oy - cy, oz - cz
        hb = rox * dx + roy * dy + roz * dz
        c = rox * rox + roy * roy + roz * roz - r2
        disc = hb * hb - c
        # disc < 0 makes sq NaN; NaN compares false everywhere below, so the
        # candidate poisons itself to +BIG — no explicit disc test needed.
        sq = fast_sqrt(disc) if fast_math else jnp.sqrt(disc)
        nhb = -hb
        t1 = nhb - sq
        if assume_outside:
            t = jnp.where(t1 >= 0.0, t1, big)
        else:
            t2 = nhb + sq
            t = jnp.where(t1 >= 0.0, t1, t2)
            t = jnp.where(t >= 0.0, t, big)
        better = t < best_t
        best_t = jnp.where(better, t, best_t)
        # index_map translates sweep position -> true scene index when the
        # sweep runs over a culled/compacted subset.
        true_i = jnp.int32(i) if index_map is None else index_map(i)
        best_i = jnp.where(better, true_i, best_i)
        bcx = jnp.where(better, jnp.broadcast_to(cx, shape), bcx)
        bcy = jnp.where(better, jnp.broadcast_to(cy, shape), bcy)
        bcz = jnp.where(better, jnp.broadcast_to(cz, shape), bcz)
        br2 = jnp.where(better, jnp.broadcast_to(r2, shape), br2)
        return best_t, best_i, bcx, bcy, bcz, br2

    carry = (best_t, best_i, best_cx, best_cy, best_cz, best_r2)
    best_t, best_i, bcx, bcy, bcz, best_r2 = jax.lax.fori_loop(
        0, sphere_count, body, carry, unroll=unroll)

    hit = best_t < big
    best_t = jnp.where(hit, best_t, f32(-1.0))
    px = ox + best_t * dx
    py = oy + best_t * dy
    pz = oz + best_t * dz
    nx, ny, nz = px - bcx, py - bcy, pz - bcz
    nn = nx * nx + ny * ny + nz * nz
    # rsqrt, not 1/sqrt: XLA rewrites the latter into the former on every
    # backend, and the kernel must run the same op (see normalize3).
    rcp = jax.lax.rsqrt(nn)
    # Avoid inf/nan normals on miss lanes (rcp of 0-length vector).
    rcp = jnp.where(hit, rcp, f32(0.0))
    return best_t, px, py, pz, nx * rcp, ny * rcp, nz * rcp, best_i, best_r2


def sphere_scene_anyhit(ox, oy, oz, dx, dy, dz, sphere_count, fetch: Fetch,
                        unroll: int = 1, assume_outside: bool = False):
    """Boolean any-hit sweep: does the ray hit ANY sphere with t >= 0?

    Exactly `intersect_sphere_scene(...)[0] >= 0` but without sqrt, t
    ordering, or winner tracking: with the reference's root choice
    (t = t1 if t1 >= 0 else t2, sphere_pathtracing.cs.glsl:157-161) a
    sphere is hit iff the origin is inside it (c < 0 => t2 >= 0) or it is
    ahead with a real root (hb < 0 and disc >= 0). Used for the LAST path
    segment, whose nearest-hit result the reference only ever tests against
    the miss sentinel for the environment lookup (glsl:312-314).
    `assume_outside` drops the inside term exactly (see
    intersect_sphere_scene).
    """
    shape = jnp.broadcast_shapes(jnp.shape(ox), jnp.shape(dx))

    def body(i, any_hit):
        cx, cy, cz, r2 = fetch(i)
        rox, roy, roz = ox - cx, oy - cy, oz - cz
        hb = rox * dx + roy * dy + roz * dz
        c = rox * rox + roy * roy + roz * roz - r2
        hit = (hb < 0.0) & (hb * hb >= c)
        if not assume_outside:
            hit = (c < 0.0) | hit
        # int32 accumulator: a plain integer loop carry on every backend.
        return any_hit | hit.astype(jnp.int32)

    any_hit = jax.lax.fori_loop(0, sphere_count, body,
                                jnp.zeros(shape, jnp.int32), unroll=unroll)
    return any_hit != 0


def intersect_triangle_scene(
    ox, oy, oz, dx, dy, dz, triangle_count: int, fetch: Fetch,
    unroll: int = 1,
):
    """Nearest hit against a flattened triangle soup.

    fetch(i) -> (v1x, v1y, v1z, e1x, e1y, e1z, e2x, e2y, e2z, mesh_id) with
    precomputed edges (see `TriangleScene.soup`).

    Möller-Trumbore mirroring `intersectTriangle`
    (triangle_pathtracing.cs.glsl:111-154): reject |det| < eps, u/v bounds,
    dist < eps. The reference's per-mesh double loop is flattened — mesh
    identity rides along as a per-triangle id, which removes all index
    chasing from the hot loop.

    Returns (t, u, v, tri_index, mesh_id): t = -1.0 on miss (normalized from
    the reference's +INF convention), (u, v) barycentrics of the winning hit.
    Attribute interpolation (normals/texcoords) is done by the caller via
    `fetch_attributes` on the winning index — once per ray, not per
    candidate (the reference does the same, interpolating after the loop,
    glsl:177-188).
    """
    shape = jnp.broadcast_shapes(jnp.shape(ox), jnp.shape(dx))
    f32 = jnp.float32
    inf = f32(jnp.inf)
    best_t = jnp.full(shape, jnp.inf, f32)
    best_u = jnp.zeros(shape, f32)
    best_v = jnp.zeros(shape, f32)
    best_tri = jnp.full(shape, -1, jnp.int32)
    best_mesh = jnp.full(shape, -1, jnp.int32)
    eps = f32(MOLLER_TRUMBORE_EPS)

    def body(i, carry):
        best_t, best_u, best_v, best_tri, best_mesh = carry
        v1x, v1y, v1z, e1x, e1y, e1z, e2x, e2y, e2z, mesh_id = fetch(i)
        # P = cross(dir, e2)
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        # Reference divides by det then rejects; we multiply by a safe
        # reciprocal and mask, same result without div-by-0.
        det_ok = jnp.abs(det) >= eps
        rcp_det = f32(1.0) / jnp.where(det_ok, det, f32(1.0))
        tx, ty, tz = ox - v1x, oy - v1y, oz - v1z
        u = (tx * px + ty * py + tz * pz) * rcp_det
        # Q = cross(T, e1)
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * rcp_det
        t = (e2x * qx + e2y * qy + e2z * qz) * rcp_det
        valid = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
                 & (u + v <= 1.0) & (t >= eps))
        t = jnp.where(valid, t, inf)
        better = t < best_t
        best_t = jnp.where(better, t, best_t)
        best_u = jnp.where(better, u, best_u)
        best_v = jnp.where(better, v, best_v)
        best_tri = jnp.where(better, jnp.int32(i), best_tri)
        best_mesh = jnp.where(
            better, jnp.broadcast_to(mesh_id, shape).astype(jnp.int32), best_mesh)
        return best_t, best_u, best_v, best_tri, best_mesh

    carry = (best_t, best_u, best_v, best_tri, best_mesh)
    best_t, best_u, best_v, best_tri, best_mesh = jax.lax.fori_loop(
        0, triangle_count, body, carry, unroll=unroll)

    # Normalize to the framework-wide miss convention t = -1.
    missed = ~jnp.isfinite(best_t)
    best_t = jnp.where(missed, f32(-1.0), best_t)
    return best_t, best_u, best_v, best_tri, best_mesh
