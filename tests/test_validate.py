"""Validation layer + profiling utility tests."""

import contextlib

import numpy as np
import jax.numpy as jnp
import pytest

from l2n.config import RenderConfig
from l2n.render.state import FrameState, init_frame_state
from l2n.scene import compute_spheres
from l2n.utils.profiling import StepTimer
from l2n.utils.validate import check_frame_state, rmse_vs_oracle

CFG = RenderConfig(width=128, height=64, tile_width=128, tile_height=32,
                   sphere_count=8, tiles_per_step=1).validate()


class TestValidation:
    def test_clean_state_ok(self):
        report = check_frame_state(init_frame_state(CFG))
        assert report.ok

    def test_detects_nan_and_inf(self):
        st = init_frame_state(CFG)
        accum = np.asarray(st.accum).copy()
        accum[0, 0, 0] = np.nan
        accum[1, 2, 3] = np.inf
        bad = FrameState(accum=jnp.asarray(accum), output=st.output,
                         tile_offset=st.tile_offset, iteration=st.iteration,
                         rng_state=None)
        report = check_frame_state(bad)
        assert not report.ok
        assert report.nan_count == 1 and report.inf_count == 1

    def test_rmse_vs_oracle_pallas_interpret(self):
        """The formalized dual-implementation gate (SURVEY §4.1): interpret
        mode on CPU is exact."""
        scene = compute_spheres(CFG.sphere_count, CFG.world_size,
                                CFG.scene_seed)
        stats = rmse_vs_oracle(CFG, scene, steps=2, backend="pallas",
                               interpret=True)
        assert stats["coverage_match"]
        assert stats["rmse"] < 1e-3
        assert stats["diverging_fraction"] < 1e-3
        assert stats["rng_match"] is None

    def test_rmse_vs_oracle_stateful_rng_planes(self):
        cfg = CFG.replace(rng="tinymt", skip_empty_tiles=False)
        scene = compute_spheres(cfg.sphere_count, cfg.world_size,
                                cfg.scene_seed)
        stats = rmse_vs_oracle(cfg, scene, steps=1, backend="pallas",
                               interpret=True)
        assert stats["rng_match"] is True
        assert stats["rmse"] < 1e-3

    @pytest.mark.parametrize("fail", [False, True])
    def test_debug_mode_scopes_nan_checks(self, fail):
        import jax
        from l2n.utils.validate import debug_mode
        before = jax.config.jax_debug_nans
        with pytest.raises(KeyError) if fail else contextlib.nullcontext():
            with debug_mode():
                assert jax.config.jax_debug_nans
                if fail:
                    raise KeyError("inside")
        assert jax.config.jax_debug_nans == before


class TestStepTimer:
    def test_metrics(self):
        t = StepTimer()
        for _ in range(3):
            with t.step():
                pass
        m = t.metrics(samples_per_step=1000, pixels=100, mean_segments=2.0)
        assert m["samples_per_sec"] > 0
        assert m["mrays_per_sec"] == pytest.approx(
            2.0 * m["samples_per_sec"] / 1e6)
