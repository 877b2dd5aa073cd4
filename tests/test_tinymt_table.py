"""The TinyMT 65,536-parameter table parity mode.

Covers VERDICT r1 missing item 2: the reference assigns every pixel a
distinct TinyMT (mat1, mat2, tmat) triple from a precomputed table of
dynamically-created generators plus an mt19937 seed
(l2n-renderer/src/main.cpp:859-878, table src/tinymt32dc.0.1048576.cpp).
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest

from l2n.rng import tinymt
from l2n.rng.state import init_tinymt_states
from l2n.rng.tinymt_params import (
    TABLE_SIZE,
    cpp_mt19937,
    load_param_table,
    parse_tinymt32dc,
)

_REF_TABLE = "l2n-renderer/src/tinymt32dc.0.1048576.cpp"


class TestArtifact:
    def test_shape_and_known_rows(self):
        tbl = load_param_table()
        assert tbl.shape == (TABLE_SIZE, 3)
        assert tbl.dtype == np.uint32
        # First row of the generated C++ data (tinymt32dc.0.1048576.cpp:4).
        assert tuple(tbl[0]) == (0x8F7011EE, 0xFC78FF1F, 0x3793FDFF)
        # Triples are distinct streams (rows unique).
        rows = np.unique(tbl, axis=0)
        assert rows.shape[0] == TABLE_SIZE

    @pytest.mark.skipif(not os.path.exists(_REF_TABLE),
                        reason="reference tree not mounted")
    def test_matches_reference_file(self):
        tbl = load_param_table()
        ref = parse_tinymt32dc(_REF_TABLE)
        np.testing.assert_array_equal(tbl, ref)


class TestCppMt19937:
    def test_canonical_values(self):
        """std::mt19937 knowns: first output for seed 5489 and the C++
        standard's 10000th-invocation check value."""
        s = cpp_mt19937(10000)
        assert s[0] == 3499211612
        assert s[9999] == 4123659995

    def test_incremental_consistency(self):
        assert np.array_equal(cpp_mt19937(700)[:100], cpp_mt19937(100))


class TestPerPixelStreams:
    def test_assignment_matches_reference_order(self):
        """Per pixel IN ORDER: seed = rng(), index = rng() % count
        (src/main.cpp:861-869) from one default-constructed engine."""
        status, params = init_tinymt_states(2, 3)
        draws = cpp_mt19937(12)
        tbl = load_param_table()
        idx = draws[1::2] % np.uint32(TABLE_SIZE)
        np.testing.assert_array_equal(
            np.asarray(params[0]).ravel(), tbl[idx, 0])
        np.testing.assert_array_equal(
            np.asarray(params[2]).ravel(), tbl[idx, 2])
        # Neighbouring pixels carry different generators.
        flat = np.asarray(params[0]).ravel()
        assert len(np.unique(flat)) > 1

    def test_streams_bit_exact_vs_native_cpp(self):
        """The kernel-side vectorized TinyMT stepping distinct per-pixel
        triples must equal the independent native C++ implementation
        stepping the same (seed, triple) pairs."""
        pytest.importorskip("ctypes")
        from l2n.native.api import tinymt_uint32_native

        h, w, n_draws = 2, 4, 16
        status, params = init_tinymt_states(h, w)
        draws = cpp_mt19937(2 * h * w)
        seeds = draws[0::2].reshape(h, w)
        tbl = load_param_table()
        idx = (draws[1::2] % np.uint32(TABLE_SIZE)).reshape(h, w)

        got = []
        st = status
        for _ in range(n_draws):
            v, st = tinymt.generate_uint32(st, params)
            got.append(np.asarray(v))
        got = np.stack(got, axis=-1)  # (h, w, n_draws)

        for y in range(h):
            for x in range(w):
                m1, m2, tm = tbl[idx[y, x]]
                want = tinymt_uint32_native(int(m1), int(m2), int(tm),
                                            int(seeds[y, x]), n_draws)
                np.testing.assert_array_equal(got[y, x], want,
                                              err_msg=f"pixel ({y},{x})")

    def test_frame_state_carries_per_pixel_params(self):
        from l2n.config import RenderConfig
        from l2n.render.state import init_frame_state

        cfg = RenderConfig(width=64, height=32, tile_height=32,
                           tile_width=128, rng="tinymt").validate()
        st = init_frame_state(cfg)
        mat1_plane = np.asarray(st.rng_state[4])
        assert len(np.unique(mat1_plane)) > 100  # per-pixel generators

    def test_canonical_mode_still_available(self):
        status, params = init_tinymt_states(1, 4, param_table="canonical")
        assert np.asarray(params[0]).shape == ()  # scalar triple
