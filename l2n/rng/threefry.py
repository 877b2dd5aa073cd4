"""Counter-based threefry-2x32 RNG (the framework's default sampler).

Replaces the reference's per-pixel stateful TinyMT32 streams
(l2n-renderer/src/main.cpp:859-878) with a stateless, counter-based
design: draw ``(u0, u1) = threefry(key=(seed, stream), counter=(pixel,
sample*K + pair))``. Properties the reference design had to buy with 28 MiB
of device state come for free:

  * independent per-pixel streams (counter includes the pixel index);
  * reproducibility across runs/devices/shardings (pure function of the key);
  * resumable progressive rendering (the "RNG state" is just the sample
    counter already tracked by the accumulation buffer).

Implemented in pure uint32 jax.numpy ops so the identical code traces inside
the Pallas kernel, in the vectorized oracle, and under `shard_map`. The
algorithm is standard Threefry-2x32 with 20 rounds (Salmon et al., "Parallel
random numbers: as easy as 1, 2, 3"), the same family JAX's own PRNG uses.
"""

from __future__ import annotations

import jax.lax as lax
import jax.numpy as jnp

# Rotation schedule for Threefry-2x32 (8 distinct rotations, cycled).
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
# Key-schedule parity constant for the 2x32 variant.
_PARITY = 0x1BD11BDA


def _rotl(x: jnp.ndarray, r: int) -> jnp.ndarray:
    return (x << jnp.uint32(r)) | (x >> jnp.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One Threefry-2x32 block: 2 words of key, 2 of counter -> 2 of output.

    All inputs are uint32 arrays (broadcastable); runs 20 rounds with key
    injections every 4 rounds.
    """
    k0 = jnp.asarray(k0, jnp.uint32)
    k1 = jnp.asarray(k1, jnp.uint32)
    x0 = jnp.asarray(x0, jnp.uint32)
    x1 = jnp.asarray(x1, jnp.uint32)
    ks = (k0, k1, k0 ^ k1 ^ jnp.uint32(_PARITY))

    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for block in range(5):
        for r in range(4):
            x0 = x0 + x1
            x1 = _rotl(x1, _ROTATIONS[(block % 2) * 4 + r])
            x1 = x1 ^ x0
        inj = block + 1
        x0 = x0 + ks[inj % 3]
        x1 = x1 + ks[(inj + 1) % 3] + jnp.uint32(inj)
    return x0, x1


def uniform_oo_from_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """uint32 -> float32 strictly inside (0, 1).

    Uses the reference's exponent trick (`tinymt32_temper_conv_open`,
    src/shaders/rand_tinymt32.cs.glsl:96-112): take the top 23 bits as a
    mantissa, force the lowest mantissa bit to 1 (0x3f800001), giving a float
    in (1, 2), then subtract 1.
    """
    u = (bits >> jnp.uint32(9)) | jnp.uint32(0x3F800001)
    return lax.bitcast_convert_type(u, jnp.float32) - jnp.float32(1.0)


def sample_draws(seed: int | jnp.ndarray, stream: int,
                 pixel_index: jnp.ndarray, sample_index: jnp.ndarray,
                 n_pairs: int) -> list[jnp.ndarray]:
    """Generate `2 * n_pairs` float32 draws in (0, 1) for each element.

    key     = (seed, stream)           -- stream separates uses (e.g. scenes)
    counter = (pixel_index, sample_index * n_pairs + pair)

    `pixel_index` and `sample_index` are uint32 arrays of equal shape; the
    result is a flat list of arrays [u0, u1, u2, ...] with that shape, the
    per-(pixel, sample) draw sequence. The mapping is collision-free as long
    as a frame uses fewer than 2**32 / n_pairs samples per pixel.
    """
    k0 = jnp.uint32(seed)
    k1 = jnp.uint32(stream)
    pixel_index = jnp.asarray(pixel_index, jnp.uint32)
    base = jnp.asarray(sample_index, jnp.uint32) * jnp.uint32(n_pairs)
    draws: list[jnp.ndarray] = []
    for pair in range(n_pairs):
        b0, b1 = threefry2x32(k0, k1, pixel_index, base + jnp.uint32(pair))
        draws.append(uniform_oo_from_bits(b0))
        draws.append(uniform_oo_from_bits(b1))
    return draws
