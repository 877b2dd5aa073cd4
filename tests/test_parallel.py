"""Multi-chip sharding tests on the virtual 8-device CPU mesh (SURVEY §4:
CPU mesh emulation; conftest forces xla_force_host_platform_device_count=8)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from l2n.camera import Camera
from l2n.config import RenderConfig
from l2n.parallel import (
    ShardedRenderer,
    make_device_mesh,
    mesh_factors,
)
from l2n.parallel.step import slab_tile_grids
from l2n.scene import compute_spheres

CFG = RenderConfig(width=256, height=128, tile_width=128, tile_height=32,
                   sphere_count=16, tiles_per_step=1).validate()


def make_renderer(n_tile, n_sample, cfg=CFG):
    mesh = make_device_mesh(n_tile, n_sample)
    scene = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    return ShardedRenderer(cfg, scene, mesh)


class TestMesh:
    def test_devices_available(self):
        assert len(jax.devices()) == 8

    def test_factors(self):
        assert mesh_factors(8, CFG) == (4, 2)
        assert mesh_factors(1, CFG) == (1, 1)

    def test_mesh_shape(self):
        mesh = make_device_mesh(4, 2)
        assert mesh.shape == {"tile": 4, "sample": 2}


class TestSlabSchedules:
    def test_shapes_and_coverage(self):
        grids = slab_tile_grids(CFG, 4)  # 4 slabs of 1 tile-row each
        assert grids.shape == (4, 2, 2)
        for s in range(4):
            ids = sorted(grids[s, :, 1] * CFG.tile_count_x + grids[s, :, 0])
            assert ids == [0, 1]

    def test_indivisible_raises(self):
        with pytest.raises(ValueError):
            slab_tile_grids(CFG, 3)


class TestShardedStep:
    def test_runs_and_accumulates(self):
        r = make_renderer(4, 2)
        cam = Camera.from_config(CFG)
        r.step(cam)
        counts = np.asarray(r.state.accum)[:, 3]
        # Each of 2 sample replicas rendered 1 tile per each of 4 slabs.
        assert counts.sum() == 2 * 4 * 32 * 128
        assert int(r.state.iteration) == 1

    def test_matches_single_device_sum(self):
        """Sample-axis psum display == tonemapped mean over all replicas."""
        r = make_renderer(2, 2)
        cam = Camera.from_config(CFG)
        for _ in range(2):
            r.step(cam)
        accum = np.asarray(r.state.accum)
        folded = accum.sum(axis=0)
        touched = folded[3] > 0
        expect = np.power(np.maximum(folded[:3][:, touched], 0)
                          / folded[3][touched], 0.45)
        got = np.asarray(r.state.output)[:, touched]
        np.testing.assert_allclose(got, expect, atol=1e-5)

    def test_fog_config_shards(self):
        """The volumetric tracer runs under the sharded step (fog flows
        through cfg into the shared trace_path)."""
        cfg = CFG.replace(fog_density=0.003, fog_albedo=0.8).validate()
        r = make_renderer(2, 2, cfg)
        cam = Camera.from_config(cfg)
        r.step(cam)
        counts = np.asarray(r.state.accum)[:, 3]
        assert counts.sum() == 2 * 2 * 32 * 128
        assert np.isfinite(np.asarray(r.state.output)).all()

    def test_tile_sharding_decorrelated_streams(self):
        """Different slabs and sample replicas draw different randoms."""
        r = make_renderer(4, 2)
        cam = Camera.from_config(CFG)
        for _ in range(CFG.tile_count):  # full coverage cycles
            r.step(cam)
        accum = np.asarray(r.state.accum)
        # Sample replicas rendered the same pixels with different streams:
        a, b = accum[0, :3], accum[1, :3]
        assert (accum[:, 3] > 0).all()
        assert not np.allclose(a, b)

    def test_display_gathers_full_image(self):
        r = make_renderer(4, 2)
        cam = Camera.from_config(CFG)
        for _ in range(CFG.tile_count):
            r.step(cam)
        img = r.display()
        assert img.shape == (128, 256, 3)
        assert np.isfinite(img).all()
        assert img.max() > 0

    def test_clear(self):
        r = make_renderer(4, 2)
        r.step(Camera.from_config(CFG))
        r.clear()
        assert np.asarray(r.state.accum).sum() == 0

    def test_tile_only_mesh(self):
        r = make_renderer(4, 1)
        r.step(Camera.from_config(CFG))
        assert np.asarray(r.state.accum)[:, 3].sum() == 4 * 32 * 128

    def test_eight_way_tile_mesh(self):
        cfg = CFG.replace(height=256)  # 8 tile rows
        r = make_renderer(8, 1, cfg)
        r.step(Camera.from_config(cfg))
        assert np.asarray(r.state.accum)[:, 3].sum() == 8 * 32 * 128

    def test_pallas_backend_matches_xla_backend(self):
        """The production kernel runs per shard inside shard_map; it must
        agree with the sharded oracle step (same draws, same schedule).
        Lit aimed frame (emissive_every=2 + camera on a lit face) — the
        default camera sees ~0.05% lit pixels on this config and the
        comparison was near-vacuous."""
        from l2n.parallel.step import build_sharded_step, init_sharded_state
        from l2n.scene import compute_spheres
        from tests.test_brdf import TestRenderIntegration
        cfg = CFG.replace(emissive_every=2)
        mesh = make_device_mesh(4, 2)
        scene = compute_spheres(cfg.sphere_count, cfg.world_size,
                                cfg.scene_seed)
        cam = TestRenderIntegration._aimed_camera(cfg)
        accums = {}
        for be in ("xla", "pallas"):
            step = build_sharded_step(cfg, scene, mesh, backend=be,
                                      interpret=True)
            st = init_sharded_state(cfg, mesh)
            for _ in range(2):
                st = step(st, cam.packed())
            accums[be] = np.asarray(st.accum)
        a, b = accums["xla"], accums["pallas"]
        assert (a[:, :3].max(1) > 0).mean() > 0.3  # real lit coverage
        np.testing.assert_array_equal(a[:, 3], b[:, 3])
        diff = np.abs(a - b)
        assert (diff > 1e-3).mean() < 1e-3  # statistical parity budget


class TestShardedCheckpoint:
    """Sharded session checkpoint + bit-exact resume — r1 VERDICT item 6."""

    def test_save_resume_bit_exact(self, tmp_path):
        r = make_renderer(4, 2)
        cam = Camera.from_config(CFG)
        r.step(cam)
        r.step(cam)
        path = r.save_session(tmp_path / "sharded.npz",
                              view_matrix=cam.view_matrix)

        # Continue the original two more steps.
        r.step(cam)
        r.step(cam)
        want = np.asarray(r.state.accum)

        # Fresh renderer resumes from the checkpoint and takes the same
        # two steps: counter-based RNG makes this bit-exact.
        r2 = make_renderer(4, 2)
        view = r2.load_session(path)
        np.testing.assert_array_equal(view, cam.view_matrix)
        r2.step(cam)
        r2.step(cam)
        np.testing.assert_array_equal(np.asarray(r2.state.accum), want)

    def test_mesh_mismatch_raises(self, tmp_path):
        r = make_renderer(4, 2)
        cam = Camera.from_config(CFG)
        r.step(cam)
        path = r.save_session(tmp_path / "s.npz")
        from l2n.utils.checkpoint import load_sharded_session
        with pytest.raises(ValueError):
            load_sharded_session(path, make_device_mesh(2, 4))


class TestStatefulRngSharding:
    """Stateful parity modes shard over 'tile' (r3 VERDICT item 6): the
    per-pixel state planes are global-image functions sliced by row, so a
    slab render must reproduce the single-device render BIT-EXACTLY — each
    pixel owns its stream, and slabbing cannot change it."""

    def _single_device_state(self, cfg, scene, steps, backend="xla"):
        from l2n.render.state import init_frame_state
        from l2n.render.step import build_render_step
        step = build_render_step(cfg, scene, backend=backend, interpret=True)
        st = init_frame_state(cfg)
        cam = Camera.from_config(cfg).packed()
        for _ in range(steps):
            st = step(st, cam)
        return st

    @pytest.mark.parametrize("backend", ["xla", "pallas"])
    @pytest.mark.parametrize("rng", ["tinymt", "tauslcg"])
    def test_sharded_matches_single_device_bit_exact(self, rng, backend):
        """Both backends (r4 VERDICT item 5: the pallas kernels thread the
        per-pixel state planes per shard too — same kernel, slab-local
        planes, so slabbing cannot change any pixel's stream)."""
        from l2n.parallel.step import (
            build_sharded_step,
            init_sharded_state,
        )
        cfg = CFG.replace(rng=rng)
        scene = compute_spheres(cfg.sphere_count, cfg.world_size,
                                cfg.scene_seed)
        # Full tile coverage in both: 8 tiles at 1/step single-device;
        # 2 per-slab tiles at 1/step across 4 slabs sharded. After one
        # full cycle every pixel took exactly spp samples from ITS OWN
        # stream, so accumulation AND stepped state planes must be equal
        # bit for bit.
        single = self._single_device_state(cfg, scene, steps=cfg.tile_count,
                                           backend=backend)
        mesh = make_device_mesh(4, 1)
        step = build_sharded_step(cfg, scene, mesh, backend=backend,
                                  interpret=True)
        st = init_sharded_state(cfg, mesh)
        cam = Camera.from_config(cfg)
        for _ in range(2):
            st = step(st, cam.packed())
        np.testing.assert_array_equal(np.asarray(st.accum[0]),
                                      np.asarray(single.accum))
        np.testing.assert_array_equal(np.asarray(st.rng_state),
                                      np.asarray(single.rng_state))

    def test_sample_axis_replicas_rejected(self):
        """One stream per pixel (reference semantics): a sample axis would
        make replicas retrace identical streams."""
        from l2n.parallel.step import init_sharded_state
        mesh = make_device_mesh(4, 2)
        with pytest.raises(ValueError, match="per-pixel"):
            init_sharded_state(CFG.replace(rng="tinymt"), mesh)

    def test_checkpoint_roundtrip_carries_streams(self, tmp_path):
        cfg = CFG.replace(rng="tauslcg")
        scene = compute_spheres(cfg.sphere_count, cfg.world_size,
                                cfg.scene_seed)
        mesh = make_device_mesh(4, 1)
        r = ShardedRenderer(cfg, scene, mesh)
        cam = Camera.from_config(cfg)
        r.step(cam)
        path = r.save_session(tmp_path / "stateful.npz")
        r2 = ShardedRenderer(cfg, scene, mesh)
        r2.load_session(path)
        np.testing.assert_array_equal(np.asarray(r2.state.rng_state),
                                      np.asarray(r.state.rng_state))
        # Resumed streams CONTINUE: the next step must equal the original
        # renderer's next step bit-exactly.
        r.step(cam)
        r2.step(cam)
        np.testing.assert_array_equal(np.asarray(r2.state.accum),
                                      np.asarray(r.state.accum))
