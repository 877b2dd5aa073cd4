"""Environment lights: Mandelbrot escape-time sky and the sun lobe.

`mandelbrot_le` mirrors the GPU kernel's env light
(l2n-renderer/src/shaders/sphere_pathtracing.cs.glsl:239-270) and `sun_le`
the CPU renderer's (src/main.cpp:401,445) — the reference deliberately uses
different env lights on the two paths; both are provided and selected by
`RenderConfig.env_mode`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from l2n.maths.fastmath import atan2
from l2n.maths.sampling import PI

MANDELBROT_ITERS = 64  # glsl:251


def any_lane(mask):
    """Scalar bool: is any lane of `mask` set? (A max over int32 lanes, not
    jnp.any: Triton's Pallas lowering has no boolean or-reduction.)"""
    return jnp.max(mask.astype(jnp.int32)) > 0


def mandelbrot_le(dx, dy, dz):
    """Scalar (greyscale) radiance of the Mandelbrot sky for direction d.

    Direction -> (u, v) plane: theta = atan2(|d.xy|, d.z), phi =
    atan2(d.y, d.x), u = phi/pi, v = -1 + 2*theta/pi, p = (8u, 4v)
    (glsl:241-248). Escape-time iteration z <- z^2 + p with the divergent
    `break` replaced by lane freezing: once |z|^2 > 4 a lane stops updating
    and remembers its escape iteration. Returns i/64 for diverged lanes, 0
    otherwise (glsl:265-269); the caller broadcasts to rgb.

    EXACT direction-space cull: |p| > 2 implies z1 = p already escaped, so
    the escape count is 0 and the radiance is exactly 0. |p| <= 2 requires
    |u| <= 1/4 and |v| <= 1/2, i.e. |phi| <= pi/4 (dx >= |dy|) and theta in
    [pi/4, 3*pi/4] (dz^2 <= dx^2 + dy^2) — a 5-op test with no atan2. A
    lane block with no in-box direction (most sky tiles; the Mandelbrot
    patch subtends 1/16 of the sphere) skips the transcendentals and the
    whole escape loop through one lax.cond.
    """
    f32 = jnp.float32
    shape = jnp.broadcast_shapes(jnp.shape(dx), jnp.shape(dy),
                                 jnp.shape(dz))
    in_box = (dx >= jnp.abs(dy)) & (dz * dz <= dx * dx + dy * dy)

    def evaluate(_):
        return _mandelbrot_eval(dx, dy, dz, shape)

    le = jax.lax.cond(any_lane(in_box), evaluate,
                      lambda _: jnp.zeros(shape, f32), None)
    # The merge is only live for the skipped branch: when `evaluate` ran,
    # out-of-box lanes already produced 0 (escape count 0).
    return jnp.where(in_box, le, f32(0.0))


def mandelbrot_begin(dx, dy, dz, shape):
    """Direction -> plane point + escape-loop state (see mandelbrot_le)."""
    f32 = jnp.float32
    sin_theta = jnp.sqrt(dx * dx + dy * dy)
    theta = atan2(sin_theta, dz)
    phi = atan2(dy, dx)
    u = phi * f32(1.0 / PI)
    v = f32(-1.0) + f32(2.0 / PI) * theta
    px = jnp.broadcast_to(f32(8.0) * u, shape)
    py = jnp.broadcast_to(f32(4.0) * v, shape)
    zero = jnp.zeros(shape, f32)
    # Branch-free escape counting: `still` is 1.0 until the lane's FIRST
    # |z|^2 > 4 (matching the reference's `break` even if |z| later
    # re-enters the disk), `cnt` accumulates iterations spent bounded, which
    # equals the reference's escape index. Lanes keep iterating after
    # escape; overflow to inf/NaN is harmless (NaN comparisons are false,
    # so `ok` stays 0 and `still` is already latched at 0): ~9 ops per
    # iteration with no select chains and no per-iteration masks.
    return (zero, zero, zero, zero, jnp.ones(shape, f32), zero, px, py)


def mandelbrot_step(carry):
    """One z <- z^2 + p escape iteration (glsl:252-261)."""
    f32 = jnp.float32
    zx, zy, zx2, zy2, still, cnt, px, py = carry
    zy = f32(2.0) * zx * zy + py
    zx = zx2 - zy2 + px
    zx2 = zx * zx
    zy2 = zy * zy
    ok = (zx2 + zy2 <= f32(4.0)).astype(f32)
    still = still * ok
    cnt = cnt + still
    return zx, zy, zx2, zy2, still, cnt, px, py


def mandelbrot_finish(carry):
    """Escape count -> radiance: i/64 for diverged lanes, 0 in-set
    (glsl:265-269)."""
    f32 = jnp.float32
    cnt = carry[5]
    return jnp.where(cnt < f32(MANDELBROT_ITERS),
                     cnt * f32(1.0 / MANDELBROT_ITERS), f32(0.0))


def _mandelbrot_eval(dx, dy, dz, shape):
    # Two-phase early exit: |p| > 2 over most of the sky, so typical lane
    # blocks fully escape within the first few iterations; one branch skips
    # the long tail when no lane is still bounded. Both phases are unrolled
    # (static trip counts).
    prefix = min(8, MANDELBROT_ITERS)
    carry = mandelbrot_begin(dx, dy, dz, shape)
    for _ in range(prefix):
        carry = mandelbrot_step(carry)

    def tail(carry):
        for _ in range(prefix, MANDELBROT_ITERS):
            carry = mandelbrot_step(carry)
        return carry

    carry = jax.lax.cond(any_lane(carry[4] > 0.0), tail, lambda c: c, carry)
    return mandelbrot_finish(carry)


def sun_le(dx, dy, dz):
    """Scalar radiance of the sun lobe: pow(max(0, dot(sunDir, d)), 128)
    with sunDir = normalize(1, 1, -1) (src/main.cpp:401,445)."""
    import math
    f32 = jnp.float32
    s = f32(1.0 / math.sqrt(3.0))
    d = jnp.maximum(f32(0.0), s * dx + s * dy - s * dz)
    # pow(x, 128) as 7 squarings — cheaper and exact for integer powers.
    for _ in range(7):
        d = d * d
    return d


def env_radiance(mode: str, dx, dy, dz):
    """Dispatch on RenderConfig.env_mode (static)."""
    if mode == "mandelbrot":
        return mandelbrot_le(dx, dy, dz)
    if mode == "sun":
        return sun_le(dx, dy, dz)
    if mode == "none":
        return jnp.zeros(jnp.broadcast_shapes(jnp.shape(dx)), jnp.float32)
    raise ValueError(f"unknown env mode {mode!r}")
