"""Bit-exact, vectorized TinyMT32 (parity RNG module).

Independent reimplementation of TinyMT32 (Saito & Matsumoto; the reference
embeds the canonical C at l2n-renderer/src/tinymt32.{hpp,cpp} and a GLSL
twin at src/shaders/rand_tinymt32.cs.glsl). State is 127 bits in four uint32
words plus the (mat1, mat2, tmat) parameter triple.

Everything operates on uint32 arrays in SoA form — `status` is a tuple of
four arrays, parameters broadcast — so one call steps *all* per-pixel streams
in lockstep, the analog of the reference's one-state-per-GL-invocation
layout (src/main.cpp:859-878). Integer-only ops make this bit-exact vs. the
C/GLSL implementations (validated against golden vectors in tests/golden/).
"""

from __future__ import annotations

import jax.lax as lax
import jax.numpy as jnp

MEXP = 127
SH0 = 1
SH1 = 10
SH8 = 8
MASK = 0x7FFFFFFF
MIN_LOOP = 8
PRE_LOOP = 8

# The canonical parameter triple used by upstream TinyMT's check program.
# The reference instead draws per-pixel triples from a 65,536-entry table of
# dynamically-created generators (src/tinymt32dc.0.1048576.cpp, generated
# data); counter-based threefry is this framework's answer to stream
# independence, so the TinyMT parity mode defaults to one canonical triple
# with per-pixel seeds (callers may pass their own triples per pixel).
DEFAULT_MAT1 = 0x8F7011EE
DEFAULT_MAT2 = 0xFC78FF1F
DEFAULT_TMAT = 0x3793FDFF

State = tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]
Params = tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]


def _u32(x) -> jnp.ndarray:
    return jnp.asarray(x, jnp.uint32)


def _neg_mask(bit: jnp.ndarray) -> jnp.ndarray:
    """-(int32)(y & 1) as uint32: all-ones when bit set, else zero."""
    return _u32(0) - bit


def next_state(status: State, params: Params) -> State:
    """State transition (tinymt32.hpp:95-111 / rand_tinymt32.cs.glsl:29-42)."""
    s0, s1, s2, s3 = status
    mat1, mat2, _ = params
    y = s3
    x = (s0 & _u32(MASK)) ^ s1 ^ s2
    x = x ^ (x << _u32(SH0))
    y = y ^ (y >> _u32(SH0)) ^ x
    n0 = s1
    n1 = s2
    n2 = x ^ (y << _u32(SH1))
    n3 = y
    m = _neg_mask(y & _u32(1))
    n1 = n1 ^ (m & _u32(mat1))
    n2 = n2 ^ (m & _u32(mat2))
    return (n0, n1, n2, n3)


def temper(status: State, params: Params) -> jnp.ndarray:
    """Output function (tinymt32.hpp:119-132)."""
    s0, _, s2, s3 = status
    _, _, tmat = params
    t1 = s0 + (s2 >> _u32(SH8))
    t0 = s3 ^ t1
    return t0 ^ (_neg_mask(t1 & _u32(1)) & _u32(tmat))


def temper_conv_open(status: State, params: Params) -> jnp.ndarray:
    """Float output in (1, 2) via the 0x3f800001 exponent trick
    (rand_tinymt32.cs.glsl:96-112)."""
    s0, _, s2, s3 = status
    _, _, tmat = params
    t1 = s0 + (s2 >> _u32(SH8))
    t0 = s3 ^ t1
    u = ((t0 ^ (_neg_mask(t1 & _u32(1)) & _u32(tmat))) >> _u32(9)) | _u32(0x3F800001)
    return lax.bitcast_convert_type(u, jnp.float32)


def generate_uint32(status: State, params: Params) -> tuple[jnp.ndarray, State]:
    status = next_state(status, params)
    return temper(status, params), status


def generate_float_oo(status: State, params: Params) -> tuple[jnp.ndarray, State]:
    """floatOO: strictly inside (0, 1) (tinymt32.hpp:250-253)."""
    status = next_state(status, params)
    return temper_conv_open(status, params) - jnp.float32(1.0), status


def init(seed: jnp.ndarray, params: Params | None = None) -> tuple[State, Params]:
    """Seed-initialize states for an array of uint32 seeds
    (tinymt32.cpp:86-100: 8-step KDF, period certification, 8 warm-up steps).
    """
    if params is None:
        params = (_u32(DEFAULT_MAT1), _u32(DEFAULT_MAT2), _u32(DEFAULT_TMAT))
    mat1, mat2, tmat = (_u32(p) for p in params)
    seed = _u32(seed)
    st = [seed, jnp.broadcast_to(mat1, seed.shape), jnp.broadcast_to(mat2, seed.shape),
          jnp.broadcast_to(tmat, seed.shape)]
    for i in range(1, MIN_LOOP):
        prev = st[(i - 1) & 3]
        st[i & 3] = st[i & 3] ^ (
            _u32(i) + _u32(1812433253) * (prev ^ (prev >> _u32(30))))
    # Period certification: if the masked state is all zero, set to 'TINY'
    # (tinymt32.cpp:68-78).
    zero = ((st[0] & _u32(MASK)) == 0) & (st[1] == 0) & (st[2] == 0) & (st[3] == 0)
    st[0] = jnp.where(zero, _u32(ord("T")), st[0])
    st[1] = jnp.where(zero, _u32(ord("I")), st[1])
    st[2] = jnp.where(zero, _u32(ord("N")), st[2])
    st[3] = jnp.where(zero, _u32(ord("Y")), st[3])
    status: State = (st[0], st[1], st[2], st[3])
    for _ in range(PRE_LOOP):
        status = next_state(status, (mat1, mat2, tmat))
    return status, (mat1, mat2, tmat)


def pack(status: State, params: Params) -> jnp.ndarray:
    """Pack to the reference's 8-word struct layout {status[4], mat1, mat2,
    tmat, pad} (src/tinymt32.hpp:60-66) — used for checkpoints."""
    shape = status[0].shape
    s = status + tuple(jnp.broadcast_to(p, shape) for p in params) + (
        jnp.zeros_like(status[0]),)
    return jnp.stack(s, axis=-1)


def unpack(arr: jnp.ndarray) -> tuple[State, Params]:
    s = tuple(arr[..., i] for i in range(4))
    p = tuple(arr[..., 4 + i] for i in range(3))
    return s, p  # type: ignore[return-value]
