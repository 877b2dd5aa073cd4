"""Combined Tausworthe + LCG hybrid RNG (alternative module).

Vectorized port of the reference's unused-but-present alternative generator
(l2n-renderer/src/shaders/rand_TausLCG.cs.glsl:5-29; GPU Gems 3 ch. 37):
three Tausworthe steps XOR'd with one LCG step. Kept for the same reason the
reference keeps it — the RNG module is swappable (src/main.cpp:688 links the
RNG as a separate compilation unit).

State is a tuple of four uint32 arrays (the GLSL uvec4), stepped in lockstep.
"""

from __future__ import annotations

import jax.numpy as jnp

State = tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]

_RCP_2_32 = 2.3283064365387e-10  # rand_TausLCG.cs.glsl:23


def _u32(x) -> jnp.ndarray:
    return jnp.asarray(x, jnp.uint32)


def taus_step(z: jnp.ndarray, s1: int, s2: int, s3: int, m: int) -> jnp.ndarray:
    b = ((z << _u32(s1)) ^ z) >> _u32(s2)
    return ((z & _u32(m)) << _u32(s3)) ^ b


def lcg_step(z: jnp.ndarray, a: int, c: int) -> jnp.ndarray:
    return _u32(a) * z + _u32(c)


def rand1(state: State) -> tuple[jnp.ndarray, State]:
    """One float32 in [0, 1) + new state (rand1_TausLCG, glsl:16-24)."""
    x, y, z, w = state
    x = taus_step(x, 13, 19, 12, 4294967294)
    y = taus_step(y, 2, 25, 4, 4294967288)
    z = taus_step(z, 3, 11, 17, 4294967280)
    w = lcg_step(w, 1664525, 1013904223)
    value = jnp.float32(_RCP_2_32) * (x ^ y ^ z ^ w).astype(jnp.float32)
    return value, (x, y, z, w)


def rand2(state: State) -> tuple[jnp.ndarray, jnp.ndarray, State]:
    u1, state = rand1(state)
    u2, state = rand1(state)
    return u1, u2, state


def init(seed: jnp.ndarray) -> State:
    """Derive a uvec4 state from uint32 seeds.

    Tausworthe steps degenerate for very small seeds, so components are
    spread with distinct odd constants and forced >= 128 (the generator
    requires z > 2^s2 for full period).
    """
    seed = _u32(seed)
    x = seed * _u32(0x9E3779B9) | _u32(128)
    y = (seed ^ _u32(0xDEADBEEF)) * _u32(0x85EBCA6B) | _u32(128)
    z = (seed + _u32(0x41C64E6D)) * _u32(0xC2B2AE35) | _u32(128)
    w = seed ^ _u32(0x6C078965)
    return (x, y, z, w)
