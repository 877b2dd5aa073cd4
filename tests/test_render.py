"""Progressive render machinery tests: tile scheduler, frame state,
accumulation semantics, determinism (reference: src/main.cpp:830-1001)."""

import numpy as np
import jax.numpy as jnp
import pytest

from l2n.camera import Camera
from l2n.config import RenderConfig
from l2n.render import (
    FrameState,
    Renderer,
    SphereProgram,
    TriangleProgram,
    clear_accumulation,
    init_frame_state,
    tile_grid,
)
from l2n.render.tiles import advance_offset, scheduled_pixel_mask, scheduled_tiles


CFG = RenderConfig(width=128, height=64, tile_width=64, tile_height=32,
                   sphere_count=16, tiles_per_step=2).validate()


class TestTiles:
    def test_grid_is_permutation(self):
        tiles = tile_grid(CFG)
        assert tiles.shape == (CFG.tile_count, 2)
        ids = tiles[:, 1] * CFG.tile_count_x + tiles[:, 0]
        assert sorted(ids.tolist()) == list(range(CFG.tile_count))

    def test_grid_shuffle_deterministic(self):
        np.testing.assert_array_equal(tile_grid(CFG), tile_grid(CFG))
        other = tile_grid(CFG.replace(tile_shuffle_seed=9))
        assert not np.array_equal(tile_grid(CFG), other)

    def test_scheduled_wraparound(self):
        tiles = jnp.asarray(tile_grid(CFG))
        t = CFG.tile_count
        sched = scheduled_tiles(tiles, jnp.int32(t - 1), 2)
        np.testing.assert_array_equal(np.asarray(sched[0]), np.asarray(tiles[t - 1]))
        np.testing.assert_array_equal(np.asarray(sched[1]), np.asarray(tiles[0]))

    def test_offset_advance_wraps(self):
        off = jnp.int32(0)
        seen = set()
        for _ in range(CFG.tile_count // 2):
            seen.add(int(off))
            off = advance_offset(CFG, off)
        assert int(off) == 0  # full cycle

    def test_pixel_mask_covers_scheduled_tiles_only(self):
        tiles = jnp.asarray(tile_grid(CFG))
        mask = np.asarray(scheduled_pixel_mask(CFG, tiles, jnp.int32(0), 2))
        assert mask.shape == (64, 128)
        assert mask.sum() == 2 * 32 * 64
        sched = np.asarray(scheduled_tiles(tiles, jnp.int32(0), 2))
        for tx, ty in sched:
            assert mask[ty * 32:(ty + 1) * 32, tx * 64:(tx + 1) * 64].all()


class TestFrameState:
    def test_init_shapes(self):
        st = init_frame_state(CFG)
        assert st.accum.shape == (4, 64, 128)
        assert st.output.shape == (3, 64, 128)
        assert st.rng_state is None  # threefry

    def test_tinymt_state_allocated(self):
        st = init_frame_state(CFG.replace(rng="tinymt"))
        assert st.rng_state.shape == (8, 64, 128)
        assert st.rng_state.dtype == jnp.uint32

    def test_clear_keeps_output_and_offset(self):
        st = init_frame_state(CFG)
        st = FrameState(accum=st.accum + 3.0, output=st.output + 0.5,
                        tile_offset=jnp.int32(7), iteration=jnp.int32(9),
                        rng_state=None)
        cl = clear_accumulation(st)
        assert float(cl.accum.max()) == 0.0
        assert float(cl.output.max()) == 0.5   # stale display kept (main.cpp:944-948)
        assert int(cl.tile_offset) == 7
        assert int(cl.iteration) == 9


class TestRenderStep:
    def make(self, cfg=CFG, **kw):
        return Renderer({"spherePT": SphereProgram(cfg, backend="xla", **kw)})

    def test_accumulates_scheduled_pixels_only(self):
        r = self.make()
        cam = Camera.from_config(r.cfg)
        r.step(cam)
        counts = np.asarray(r.state.accum[3])
        assert counts.sum() == 2 * 32 * 64
        assert set(np.unique(counts)) == {0.0, 1.0}

    def test_full_cycle_uniform_coverage(self):
        r = self.make()
        cam = Camera.from_config(r.cfg)
        for _ in range(r.cfg.tile_count // 2):
            r.step(cam)
        counts = np.asarray(r.state.accum[3])
        assert (counts == 1.0).all()
        assert int(r.state.tile_offset) == 0
        assert int(r.state.iteration) == r.cfg.tile_count // 2

    def test_deterministic_across_instances(self):
        ra, rb = self.make(), self.make()
        cam = Camera.from_config(ra.cfg)
        for _ in range(3):
            ra.step(cam)
            rb.step(cam)
        np.testing.assert_array_equal(np.asarray(ra.state.accum),
                                      np.asarray(rb.state.accum))

    def test_progressive_convergence(self):
        """Variance of the estimate must shrink as samples accumulate."""
        cfg = CFG.replace(width=64, height=32, tile_width=64, tile_height=32,
                          tiles_per_step=1)  # one tile = whole image
        r = self.make(cfg)
        cam = Camera.from_config(r.cfg)
        r.step(cam)
        early = np.asarray(r.state.output)
        for _ in range(15):
            r.step(cam)
        mid = np.asarray(r.state.accum[:3] / r.state.accum[3:])
        for _ in range(16):
            r.step(cam)
        late = np.asarray(r.state.accum[:3] / r.state.accum[3:])
        # successive mean images move less and less
        d1 = np.abs(mid - early).mean()
        d2 = np.abs(late - mid).mean()
        assert d2 < d1

    def test_switch_clears_accum(self):
        cfg = CFG.replace(sphere_count=4, disc_lat=8, disc_long=4)
        progs = {"spherePT": SphereProgram(cfg, backend="xla"),
                 "trianglePT": TriangleProgram(cfg, backend="xla")}
        r = Renderer(progs)
        cam = Camera.from_config(r.cfg)
        r.step(cam)
        assert np.asarray(r.state.accum[3]).sum() > 0
        r.switch("trianglePT")
        assert np.asarray(r.state.accum[3]).sum() == 0
        r.step(cam)  # triangle program renders fine
        assert np.asarray(r.state.accum[3]).sum() > 0

    def test_camera_move_clears(self):
        r = self.make()
        cam = Camera.from_config(r.cfg)
        r.step(cam)
        r.on_camera_moved()
        assert np.asarray(r.state.accum).sum() == 0

    def test_tinymt_backend_runs_and_advances_state(self):
        cfg = CFG.replace(rng="tinymt", sphere_count=8)
        r = self.make(cfg)
        cam = Camera.from_config(r.cfg)
        before = np.asarray(r.state.rng_state)
        r.step(cam)
        after = np.asarray(r.state.rng_state)
        mask = np.asarray(r.state.accum[3]) > 0
        assert (before[:, mask] != after[:, mask]).any()
        np.testing.assert_array_equal(before[:, ~mask], after[:, ~mask])

    def test_tauslcg_backend_runs(self):
        cfg = CFG.replace(rng="tauslcg", sphere_count=8)
        r = self.make(cfg)
        cam = Camera.from_config(r.cfg)
        r.step(cam)
        assert np.asarray(r.state.accum[3]).sum() > 0

    def test_output_is_tonemapped_mean(self):
        r = self.make()
        cam = Camera.from_config(r.cfg)
        r.step(cam)
        st = r.state
        mask = np.asarray(st.accum[3]) > 0
        mean = np.asarray(st.accum[:3])[:, mask] / 1.0
        np.testing.assert_allclose(np.asarray(st.output)[:, mask],
                                   np.power(np.maximum(mean, 0), 0.45),
                                   atol=1e-5)

    def test_metrics_shape(self):
        r = self.make()
        cam = Camera.from_config(r.cfg)
        r.step(cam, block=True)  # warm-up/compile step — excluded from stats
        r.step(cam, block=True)
        m = r.metrics()
        assert m["iteration"] == 2 and m["samples_per_sec"] > 0
