"""RNG subsystem tests: TinyMT bit-parity golden vectors, threefry
properties, TausLCG, sampler protocol."""

import json
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from l2n.rng import tauslcg, tinymt
from l2n.rng.sampler import (
    MaskedSampler,
    TausLCGSampler,
    ThreefrySampler,
    TinyMTSampler,
    max_pairs_per_sample,
)
from l2n.rng.state import init_tinymt_states
from l2n.rng.threefry import sample_draws, threefry2x32, uniform_oo_from_bits

GOLDEN = json.loads(
    (Path(__file__).parent / "golden" / "tinymt32_vectors.json").read_text())


class TestTinyMTGolden:
    """Bit-exact parity with the canonical C implementation (golden vectors
    generated from the reference's src/tinymt32.{hpp,cpp})."""

    @pytest.mark.parametrize("case", GOLDEN, ids=lambda c: f"seed{c['seed']}")
    def test_init_state(self, case):
        params = tuple(jnp.uint32(case[k]) for k in ("mat1", "mat2", "tmat"))
        status, _ = tinymt.init(jnp.uint32(case["seed"]), params)
        got = [int(s) for s in status]
        assert got == case["state_after_init"]

    @pytest.mark.parametrize("case", GOLDEN, ids=lambda c: f"seed{c['seed']}")
    def test_uint32_stream(self, case):
        params = tuple(jnp.uint32(case[k]) for k in ("mat1", "mat2", "tmat"))
        status, params = tinymt.init(jnp.uint32(case["seed"]), params)
        got = []
        for _ in range(len(case["uint32"])):
            v, status = tinymt.generate_uint32(status, params)
            got.append(int(v))
        assert got == case["uint32"]

    @pytest.mark.parametrize("case", GOLDEN, ids=lambda c: f"seed{c['seed']}")
    def test_float_oo_stream_bits(self, case):
        params = tuple(jnp.uint32(case[k]) for k in ("mat1", "mat2", "tmat"))
        status, params = tinymt.init(jnp.uint32(case["seed"]), params)
        got = []
        for _ in range(len(case["float_oo_bits"])):
            v, status = tinymt.generate_float_oo(status, params)
            got.append(int(np.asarray(v).view(np.uint32)))
        assert got == case["float_oo_bits"]

    def test_vectorized_matches_scalar(self):
        """Stepping many states in lockstep == stepping each alone."""
        seeds = jnp.arange(64, dtype=jnp.uint32)
        status, params = tinymt.init(seeds)
        vec, _ = tinymt.generate_uint32(status, params)
        for i in (0, 7, 63):
            s_i, p_i = tinymt.init(jnp.uint32(i))
            v_i, _ = tinymt.generate_uint32(s_i, p_i)
            assert int(vec[i]) == int(v_i)

    def test_pack_unpack_roundtrip(self):
        status, params = tinymt.init(jnp.arange(8, dtype=jnp.uint32))
        packed = tinymt.pack(status, params)
        assert packed.shape == (8, 8)  # reference struct is 8 words (tinymt32.hpp:60-66)
        s2, p2 = tinymt.unpack(packed)
        for a, b in zip(status + params, s2 + p2):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestThreefry:
    def test_matches_jax_prng(self):
        """Our in-kernel threefry must equal JAX's threefry2x32 (same
        algorithm) — guards against rotation/injection mistakes."""
        from jax._src.prng import threefry_2x32
        key = jnp.array([42, 7], dtype=jnp.uint32)
        count = jnp.arange(32, dtype=jnp.uint32)
        expect = threefry_2x32(key, count)  # counter pairs = split halves
        x0, x1 = count[:16], count[16:]
        got0, got1 = threefry2x32(jnp.uint32(42), jnp.uint32(7), x0, x1)
        np.testing.assert_array_equal(np.asarray(expect[:16]), np.asarray(got0))
        np.testing.assert_array_equal(np.asarray(expect[16:]), np.asarray(got1))

    def test_uniform_oo_open_interval(self):
        bits = jnp.asarray(
            np.array([0, 1, 0xFFFFFFFF, 0x80000000, 512], dtype=np.uint32))
        u = np.asarray(uniform_oo_from_bits(bits))
        assert (u > 0.0).all() and (u < 1.0).all()

    def test_sample_draws_shapes_and_determinism(self):
        pix = jnp.arange(100, dtype=jnp.uint32)
        s0 = jnp.zeros(100, jnp.uint32)
        a = sample_draws(7, 0, pix, s0, 3)
        b = sample_draws(7, 0, pix, s0, 3)
        assert len(a) == 6
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    def test_streams_decorrelated(self):
        pix = jnp.arange(4096, dtype=jnp.uint32)
        s0 = jnp.zeros(4096, jnp.uint32)
        a = np.asarray(sample_draws(7, 0, pix, s0, 1)[0])
        b = np.asarray(sample_draws(7, 1, pix, s0, 1)[0])
        c = np.asarray(sample_draws(8, 0, pix, s0, 1)[0])
        assert abs(np.corrcoef(a, b)[0, 1]) < 0.05
        assert abs(np.corrcoef(a, c)[0, 1]) < 0.05
        assert abs(a.mean() - 0.5) < 0.02

    def test_consecutive_samples_distinct(self):
        pix = jnp.zeros(1, jnp.uint32)
        u0 = sample_draws(7, 0, pix, jnp.uint32([0]), 4)
        u1 = sample_draws(7, 0, pix, jnp.uint32([1]), 4)
        assert all(float(a[0]) != float(b[0]) for a, b in zip(u0, u1))


class TestTausLCG:
    def test_reference_constants_sequence(self):
        """First outputs for a known state, per rand_TausLCG.cs.glsl:16-24."""
        state = (jnp.uint32(129), jnp.uint32(130), jnp.uint32(131),
                 jnp.uint32(132))
        # Hand-step once in numpy (independent arithmetic).
        def taus(z, s1, s2, s3, m):
            z = np.uint64(z)
            b = ((z << np.uint64(s1)) ^ z) % (1 << 32) >> np.uint64(s2)
            return (((z & np.uint64(m)) << np.uint64(s3)) ^ b) % (1 << 32)
        x = taus(129, 13, 19, 12, 4294967294)
        y = taus(130, 2, 25, 4, 4294967288)
        z = taus(131, 3, 11, 17, 4294967280)
        w = (1664525 * 132 + 1013904223) % (1 << 32)
        expect = 2.3283064365387e-10 * np.float32(x ^ y ^ z ^ w)
        got, _ = tauslcg.rand1(state)
        np.testing.assert_allclose(float(got), float(expect), rtol=1e-6)

    def test_range_and_mean(self):
        state = tauslcg.init(jnp.arange(4096, dtype=jnp.uint32))
        vals = []
        for _ in range(4):
            v, state = tauslcg.rand1(state)
            vals.append(np.asarray(v))
        v = np.concatenate(vals)
        assert (v >= 0).all() and (v < 1.0 + 1e-6).all()
        assert abs(v.mean() - 0.5) < 0.02


class TestSamplers:
    def test_threefry_budget_enforced(self):
        s = ThreefrySampler(0, 0, jnp.uint32([1]), jnp.uint32([0]), 2)
        s.draw2(); s.draw2()
        with pytest.raises(RuntimeError):
            s.draw1()

    def test_masked_tinymt_advances_only_masked_lanes(self):
        """The parity property: masked lanes' streams must not advance —
        this is what reproduces the reference's branch-dependent draw
        consumption (glsl:285-309)."""
        status, params = init_tinymt_states(1, 8, seed=3)
        sampler = TinyMTSampler(status, params)
        mask = jnp.asarray([[True, False] * 4])
        sampler.draw1(mask=mask)
        stepped = sampler.final_state()
        for w_new, w_old in zip(stepped, status):
            same = np.asarray(w_new) == np.asarray(w_old)
            np.testing.assert_array_equal(same[0, 1::2], True)   # masked-off lanes
        # Unmasked lanes did advance (word 3 always changes).
        assert (np.asarray(stepped[3])[0, 0::2]
                != np.asarray(status[3])[0, 0::2]).all()

    def test_masked_sampler_combines_masks(self):
        status, params = init_tinymt_states(1, 4, seed=5)
        lane = jnp.asarray([[True, True, False, False]])
        inner = TinyMTSampler(status, params)
        m = MaskedSampler(inner, lane)
        extra = jnp.asarray([[True, False, True, False]])
        m.draw1(mask=extra)
        stepped = m.final_state()
        changed = np.asarray(stepped[3]) != np.asarray(status[3])
        np.testing.assert_array_equal(changed[0], [True, False, False, False])

    def test_max_pairs(self):
        assert max_pairs_per_sample(2) == 6

    def test_tauslcg_sampler(self):
        s = TausLCGSampler(tauslcg.init(jnp.arange(4, dtype=jnp.uint32)))
        u1, u2 = s.draw2()
        assert np.asarray(u1).shape == (4,)
        assert s.final_state() is not None
