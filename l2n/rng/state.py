"""Per-pixel stateful RNG initialization (TinyMT / TausLCG parity modes).

Analog of `computeTinyMTStateVector` (l2n-renderer/src/main.cpp:859-878):
one RNG state per pixel. By default the TinyMT mode reproduces the
reference's scheme EXACTLY: a default-constructed std::mt19937 (bit-exact
reimplementation, rng.tinymt_params.cpp_mt19937) draws, per pixel in order,
a 32-bit seed and then an index into the shipped 65,536-entry precomputed
parameter table (src/tinymt32dc.0.1048576.cpp — dynamically-created TinyMT
generators, hence statistically independent per-pixel streams), and
`tinymt32_init` builds the state from (seed, mat1, mat2, tmat)
(src/main.cpp:861-869).

`param_table="canonical"` keeps every pixel on the canonical TinyMT triple
(distinct seeds only); an (N, 3) uint32 array substitutes a custom table.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from l2n.rng import tinymt, tauslcg
from l2n.rng.tinymt_params import cpp_mt19937, load_param_table


def mt19937_seeds(n: int, seed: int = 0) -> np.ndarray:
    """n uint32 seeds from a Mersenne Twister (numpy generator; used by the
    modes that only need reproducible distinct seeds)."""
    gen = np.random.Generator(np.random.MT19937(seed))
    return gen.integers(0, 2**32, size=n, dtype=np.uint32)


def init_tinymt_states(
    height: int, width: int, seed: int = 0,
    param_table: np.ndarray | str | None = "reference",
) -> tuple[tinymt.State, tinymt.Params]:
    """One TinyMT32 state per pixel, shaped (height, width).

    param_table:
      * "reference" (default) — the shipped 65,536-entry table with the
        reference's exact per-pixel (seed, parameter) assignment: one
        std::mt19937 stream, two draws per pixel in row-major order
        (src/main.cpp:861-869). `seed` 0 maps to std::mt19937's default
        seed (5489), matching the reference's default-constructed engine.
      * "canonical" / None — the canonical TinyMT triple for every pixel,
        seeds from a numpy MT19937 (a documented deviation kept for cheap
        tests).
      * (N, 3) uint32 array — a custom table, same draw order as above.
    """
    if isinstance(param_table, str) and param_table == "reference":
        table = load_param_table()
    elif param_table is None or (isinstance(param_table, str)
                                 and param_table == "canonical"):
        table = None
    else:
        table = np.asarray(param_table, dtype=np.uint32)

    if table is None:
        gen = np.random.Generator(np.random.MT19937(seed))
        seeds = gen.integers(0, 2**32, size=(height, width), dtype=np.uint32)
        return tinymt.init(jnp.asarray(seeds), None)

    n = height * width
    draws = cpp_mt19937(2 * n, 5489 if seed == 0 else seed)
    seeds = draws[0::2].reshape(height, width)
    idx = (draws[1::2] % np.uint32(table.shape[0])).reshape(height, width)
    params = (jnp.asarray(table[idx, 0]), jnp.asarray(table[idx, 1]),
              jnp.asarray(table[idx, 2]))
    return tinymt.init(jnp.asarray(seeds), params)


def init_tauslcg_states(height: int, width: int, seed: int = 0) -> tauslcg.State:
    """One TausLCG uvec4 state per pixel, shaped (height, width)."""
    seeds = mt19937_seeds(height * width, seed).reshape(height, width)
    return tauslcg.init(jnp.asarray(seeds))
