"""Device-side sampling / frame math in structure-of-arrays form (jax.numpy).

Every function takes and returns *components* (arrays of identical shape), so
the same code traces inside the Pallas kernel (on pixel blocks) and in the
vectorized oracle renderer (on full-image arrays) — the lane-array form of
the reference's per-thread GLSL functions
(l2n-renderer/src/shaders/sphere_pathtracing.cs.glsl:102-143,215-226).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

PI = 3.14159265358979323846  # M_PI, sphere_pathtracing.cs.glsl:7

Vec3 = tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]


def dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def cross3(ax, ay, az, bx, by, bz) -> Vec3:
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def fast_sqrt(x):
    """jnp.sqrt(x) as x * rsqrt(x) — the fast-math form (cfg.fast_math).

    Final-ulp differences from `jnp.sqrt` only; x == 0 yields NaN (0 * inf)
    where sqrt gives 0 — callers either tolerate the poison (sweep
    candidates, dead lanes) or clamp the argument away from 0 first. x < 0
    is NaN either way.
    """
    return x * jax.lax.rsqrt(x)


def normalize3(x, y, z) -> Vec3:
    """v / |v| as v * rsqrt(v.v). Written as rsqrt on purpose: XLA rewrites
    a / sqrt(b) into a * rsqrt(b) on every backend, and spelling it out
    gives the Triton kernel the identical operation (a divide by sqrt there
    rounds differently and flips near-tie events against the oracle)."""
    nn = x * x + y * y + z * z
    rcp = jax.lax.rsqrt(nn)
    return (x * rcp, y * rcp, z * rcp)


def luminance(r, g, b):
    """Rec.709 luminance (sphere_pathtracing.cs.glsl:224-226)."""
    return (jnp.float32(0.212671) * r + jnp.float32(0.715160) * g
            + jnp.float32(0.072169) * b)


def frame_z(zx, zy, zz) -> tuple[Vec3, Vec3]:
    """Build a tangent frame around a normalized z axis.

    Mirrors `frameZ` (sphere_pathtracing.cs.glsl:102-117): the tangent is
    chosen from the smaller of |z.x|,|z.y| — branch becomes a lane-wise
    select. Returns (tangent, bitangent); the z axis is the input. Lengths
    invert through rsqrt, as in normalize3.
    """
    _rcp = jax.lax.rsqrt

    use_y = jnp.abs(zy) > jnp.abs(zx)
    # Branch A (|z.y| > |z.x|): t = (z.y, -z.x, 0) / len(z.xy)
    rcp_a = _rcp(zx * zx + zy * zy)
    ax, ay, az = zy * rcp_a, -zx * rcp_a, jnp.zeros_like(zx)
    # Branch B: t = (z.z, 0, -z.x) / len(z.xz)
    rcp_b = _rcp(zx * zx + zz * zz)
    bx, by, bz = zz * rcp_b, jnp.zeros_like(zx), -zx * rcp_b
    tx = jnp.where(use_y, ax, bx)
    ty = jnp.where(use_y, ay, by)
    tz = jnp.where(use_y, az, bz)
    # bitangent = cross(z, tangent) (glsl:115)
    bxx, bxy, bxz = cross3(zx, zy, zz, tx, ty, tz)
    return (tx, ty, tz), (bxx, bxy, bxz)


def local_to_world(localx, localy, localz, tangent: Vec3, bitangent: Vec3,
                   zaxis: Vec3) -> Vec3:
    """Apply the frameZ basis: world = T*l.x + B*l.y + Z*l.z (mat3 * vec)."""
    tx, ty, tz = tangent
    bx, by, bz = bitangent
    zx, zy, zz = zaxis
    return (
        tx * localx + bx * localy + zx * localz,
        ty * localx + by * localy + zy * localz,
        tz * localx + bz * localy + zz * localz,
    )


def cosine_sample_hemisphere(u1, u2) -> tuple[Vec3, jnp.ndarray]:
    """Cosine-weighted hemisphere sample (sphere_pathtracing.cs.glsl:127-136).

    Returns ((x, y, z), jacobian); jacobian = pi / cosTheta (0 where
    cosTheta == 0), matching the GLSL ternary. Deliberately NOT in the
    rsqrt form: that would need 1e-30 clamps against the masked-lane
    u1 == 0 draw.
    """
    r = jnp.sqrt(u1)
    phi = jnp.float32(2.0 * PI) * u2
    cos_theta = jnp.sqrt(jnp.maximum(jnp.float32(0.0), jnp.float32(1.0) - u1))
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    jac = jnp.where(cos_theta > 0.0, jnp.float32(PI) / cos_theta,
                    jnp.float32(0.0))
    return (x, y, cos_theta), jac


def uniform_sample_hemisphere(u1, u2) -> tuple[Vec3, jnp.ndarray]:
    """Uniform hemisphere sample (sphere_pathtracing.cs.glsl:119-125)."""
    r = jnp.sqrt(jnp.float32(1.0) - u1 * u1)
    phi = jnp.float32(2.0 * PI) * u2
    jac = jnp.full_like(u1, 2.0 * PI)
    return (jnp.cos(phi) * r, jnp.sin(phi) * r, u1), jac


def uniform_sample_disk(radius, u1, u2) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Uniform disk sample (sphere_pathtracing.cs.glsl:138-143).

    Returns (x, y, jacobian).
    """
    r = jnp.sqrt(u1)
    theta = jnp.float32(2.0 * PI) * u2
    jac = jnp.float32(PI) * r * r
    return radius * r * jnp.cos(theta), radius * r * jnp.sin(theta), jac


def procedural_color(n) -> Vec3:
    """Per-object pseudo-random albedo: fract(sin((n+1)*k)*43758.5453)
    (`getColor`, sphere_pathtracing.cs.glsl:215-222). `n` is an integer array."""
    f = (n + 1).astype(jnp.float32)
    def chan(k):
        v = jnp.sin(f * jnp.float32(k)) * jnp.float32(43758.5453)
        return v - jnp.floor(v)
    return chan(12.9898), chan(78.233), chan(56.128)
