"""Animated UV-gradient test pattern.

Rebuild of the reference's unused demo shader
(l2n-renderer/src/shaders/uv.cs.glsl): writes
(0.5*(1+cos(t)) * u, 0.5*(1+sin(t)) * v, 0) over the whole image with
global (non-tiled) indexing. Three elementwise expressions, so plain
`jax.numpy` — XLA fuses them into one kernel.
"""

from __future__ import annotations

import jax.numpy as jnp


def uv_demo(height: int, width: int, time_s) -> jnp.ndarray:
    """(3, height, width) animated UV pattern (uv.cs.glsl:12-20)."""
    f32 = jnp.float32
    t = jnp.asarray(time_s, f32)
    u = jnp.arange(width, dtype=f32)[None, :] / f32(width)
    v = jnp.arange(height, dtype=f32)[:, None] / f32(height)
    r = f32(0.5) * (f32(1.0) + jnp.cos(t)) * u
    g = f32(0.5) * (f32(1.0) + jnp.sin(t)) * v
    return jnp.stack([jnp.broadcast_to(r, (height, width)),
                      jnp.broadcast_to(g, (height, width)),
                      jnp.zeros((height, width), f32)])
