"""RNG subsystem.

The reference carries one mutable 32-byte TinyMT32 state per pixel (28 MiB at
720p, l2n-renderer/src/main.cpp:859-878) with per-pixel parameter sets for
stream independence, plus an unused TausLCG alternative module
(src/shaders/rand_TausLCG.cs.glsl). The default here replaces all of
that with **counter-based threefry-2x32 keyed on (pixel, sample, draw)** —
stateless, bit-reproducible, zero memory traffic — while bit-exact TinyMT32
and TausLCG ports are kept as swappable parity modules (the reference links
the RNG as a separate GLSL compilation unit for exactly this swappability,
src/main.cpp:688).

All generators expose `sample_draws(...)` returning float32 draws in the open
interval (0, 1), matching `tinymt32_generate_floatOO` semantics
(src/tinymt32.hpp:250-253: value can never be exactly 0.0 or 1.0).
"""

from l2n.rng.threefry import (  # noqa: F401
    threefry2x32,
    uniform_oo_from_bits,
    sample_draws,
)
from l2n.rng import tinymt, tauslcg  # noqa: F401
