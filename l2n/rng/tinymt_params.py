"""The TinyMT32 precomputed parameter table (65,536 independent streams).

The reference ships 65,536 distinct TinyMT (mat1, mat2, tmat) parameter sets
— dynamically-created generators, hence statistically independent streams —
as generated C++ data (l2n-renderer/src/tinymt32dc.0.1048576.cpp, 65,544
lines; produced from the upstream `tinymt32dc` tool's text output by
l2n-renderer/resources/to_cpp.py). Each pixel's RNG draws one set at
startup (src/main.cpp:859-878).

Here the table ships as a compressed NPZ artifact next to this module
(regenerate with `python -m l2n.rng.tinymt_params <path-to-cpp> <npz>`),
and `cpp_mt19937` reproduces std::mt19937's exact output stream so the
per-pixel (seed, parameter) assignment matches `computeTinyMTStateVector`
bit for bit (src/main.cpp:861-869: per pixel, seed = rng() then
index = rng() % count, from a default-constructed std::mt19937).
"""

from __future__ import annotations

import pathlib
import re

import numpy as np

PARAMS_NPZ = pathlib.Path(__file__).with_name("tinymt32dc_params.npz")
TABLE_SIZE = 65536

_ROW_RE = re.compile(
    r"\{\s*0x([0-9a-fA-F]{1,8})\s*,\s*0x([0-9a-fA-F]{1,8})\s*,"
    r"\s*0x([0-9a-fA-F]{1,8})\s*\}")


def parse_tinymt32dc(path: str | pathlib.Path) -> np.ndarray:
    """Parse the generated C++ table into an (N, 3) uint32 array of
    (mat1, mat2, tmat) rows, in file order."""
    rows = []
    with open(path) as f:
        for line in f:
            m = _ROW_RE.search(line)
            if m:
                rows.append([int(g, 16) for g in m.groups()])
    return np.asarray(rows, dtype=np.uint32)


def load_param_table() -> np.ndarray:
    """The shipped (65536, 3) uint32 table."""
    with np.load(PARAMS_NPZ) as z:
        return z["params"]


def cpp_mt19937(n: int, seed: int = 5489) -> np.ndarray:
    """First `n` outputs of std::mt19937 — bit-exact.

    Implements init_genrand seeding + the MT19937 twist/temper (the C++
    standard's mersenne_twister_engine with the default seed 5489, as
    default-constructed at src/main.cpp:861).
    """
    with np.errstate(over="ignore"):
        mt = np.empty(624, np.uint32)
        mt[0] = np.uint32(seed)
        for i in range(1, 624):
            mt[i] = (np.uint32(1812433253)
                     * (mt[i - 1] ^ (mt[i - 1] >> np.uint32(30)))
                     + np.uint32(i))

        out = np.empty(n, np.uint32)
        produced = 0
        upper = np.uint32(0x80000000)
        lower = np.uint32(0x7FFFFFFF)
        mag = np.array([0, 0x9908B0DF], np.uint32)
        one = np.uint32(1)
        while produced < n:
            # One in-place twist of the 624-word block, vectorized as the
            # classic three segments (mt[i] = mt[(i+397)%624] ^ f(mt[i],
            # mt[i+1]) where sources past the wrap point are ALREADY
            # twisted, and the last word pairs with the NEW mt[0]).
            new = np.empty_like(mt)
            y = (mt[:623] & upper) | (mt[1:624] & lower)
            xa = (y >> one) ^ mag[y & one]
            new[:227] = mt[397:624] ^ xa[:227]
            # The middle segment reads its own earlier outputs (new[i-227]),
            # so split it where the self-dependency starts (i = 454).
            new[227:454] = new[0:227] ^ xa[227:454]
            new[454:623] = new[227:396] ^ xa[454:623]
            y_last = (mt[623] & upper) | (new[0] & lower)
            new[623] = new[396] ^ (y_last >> one) ^ mag[y_last & one]
            mt = new

            take = min(624, n - produced)
            z = mt.copy()
            z ^= z >> np.uint32(11)
            z ^= (z << np.uint32(7)) & np.uint32(0x9D2C5680)
            z ^= (z << np.uint32(15)) & np.uint32(0xEFC60000)
            z ^= z >> np.uint32(18)
            out[produced:produced + take] = z[:take]
            produced += take
    return out
