"""Transcendentals built from multiply-adds, identical on every backend.

`atan2` is needed by the Mandelbrot environment light's direction->(u,v)
mapping (sphere_pathtracing.cs.glsl:243-244). Library atan2 differs in the
last ulp between XLA's and Triton's lowerings, so it is implemented here
with an odd minimax polynomial on [0, 1] plus octant reduction, and the
oracle and the kernel compute the same values (~1e-5 rad absolute error,
far below a 1/64-quantized escape-time texture's resolution).
"""

from __future__ import annotations

import jax.numpy as jnp

_HALF_PI = 1.5707963267948966
_PI = 3.141592653589793

# Odd minimax polynomial for atan(t), t in [-1, 1] (f32, ~1e-5 max error).
_C = (0.99997726, -0.33262347, 0.19354346, -0.11643287, 0.05265332,
      -0.01172120)


def _atan_poly(t):
    s = t * t
    p = jnp.float32(_C[5])
    for c in _C[4::-1]:
        p = p * s + jnp.float32(c)
    return t * p


def atan2(y, x):
    """Four-quadrant arctangent, elementwise on float32 arrays.

    Matches np.arctan2 conventions to ~1e-5 rad (including the y == +-0,
    x < 0 -> +-pi edge via the sign select below going to +pi).
    """
    ax = jnp.abs(x)
    ay = jnp.abs(y)
    hi = jnp.maximum(ax, ay)
    lo = jnp.minimum(ax, ay)
    t = lo / jnp.maximum(hi, jnp.float32(1e-37))
    a = _atan_poly(t)
    a = jnp.where(ay > ax, jnp.float32(_HALF_PI) - a, a)
    a = jnp.where(x < 0.0, jnp.float32(_PI) - a, a)
    return jnp.where(y < 0.0, -a, a)


def atan(x):
    """Arctangent via atan2(x, 1)."""
    return atan2(x, jnp.ones_like(x))
