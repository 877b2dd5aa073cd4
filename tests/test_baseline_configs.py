"""The five workload configs of the original build plan (SURVEY.md §7),
exercised end-to-end (scaled down for CPU CI; bench.py runs the full-size
flagship on the GPU)."""

import numpy as np
import pytest

from l2n.camera import Camera, ControllerInput
from l2n.config import RenderConfig
from l2n.render import Renderer, SphereProgram, init_frame_state
from l2n.render.state import display_image


def renderer(cfg, backend="xla"):
    return Renderer({"spherePT": SphereProgram(cfg, backend=backend)})


class TestBaselineConfigs:
    def test_config1_primary_ray_flat_shade(self):
        """'primary-ray flat-shade render of hard-coded scene, 256x256,
        1 frame (CPU jit)' — the normal AOV is the flat-shade channel."""
        cfg = RenderConfig(width=256, height=256, tile_width=128,
                           tile_height=32, aov="normal",
                           tiles_per_step=16).validate()
        r = renderer(cfg)
        r.step(Camera.from_config(cfg), block=True)
        img = r.display()
        assert img.shape == (256, 256, 3)
        assert np.isfinite(img).all()
        assert (np.asarray(r.state.accum[3]) == 1.0).all()

    def test_config2_progressive_accumulation(self):
        """'progressive accumulation, 1 spp/frame with counter-based RNG'
        — variance of the running mean must fall like 1/n."""
        cfg = RenderConfig(width=128, height=64, tile_width=128,
                           tile_height=32, tiles_per_step=2,
                           rng="threefry").validate()
        r = renderer(cfg)
        cam = Camera.from_config(cfg)
        means = []
        for frame in range(3 * cfg.tile_count):
            r.step(cam)
            if (frame + 1) % cfg.tile_count == 0:
                acc = np.asarray(r.state.accum)
                means.append(acc[:3] / np.maximum(acc[3], 1))
        d1 = np.abs(means[1] - means[0]).mean()
        d2 = np.abs(means[2] - means[1]).mean()
        assert d2 < d1  # converging

    def test_config3_depth4_rr_with_camera_reset(self):
        """'multi-bounce diffuse GI (depth 4, Russian roulette) with
        accumulation reset on camera move'."""
        cfg = RenderConfig(width=128, height=64, tile_width=128,
                           tile_height=32, tiles_per_step=2,
                           max_bounces=4).validate()
        r = renderer(cfg)
        cam = Camera.from_config(cfg)
        r.step(cam)
        assert np.asarray(r.state.accum[3]).sum() > 0
        r.on_camera_moved()
        assert np.asarray(r.state.accum).sum() == 0
        r.step(cam)
        assert np.isfinite(np.asarray(r.state.accum)).all()

    def test_config4_interactive_loop(self):
        """'interactive loop: ViewController orbit/FPS camera + host
        readback' — scripted drag orbit with per-frame display readback."""
        from l2n.app import Application
        cfg = RenderConfig(width=128, height=64, tile_width=128,
                           tile_height=32, sphere_count=8,
                           tiles_per_step=1).validate()
        app = Application(cfg, backend="xla", renderer_names=("spherePT",))
        poses = []

        def orbit(frame):
            poses.append(app.controller.view_matrix.copy())
            return ControllerInput(dragging=True, cursor_dx=4.0)

        app.run(4, input_source=orbit, save_camera=False)
        img = display_image(cfg, app.renderer.state)
        assert img.shape == (64, 128, 3)
        # Camera orbited: view matrices differ between frames.
        assert not np.allclose(poses[0], poses[-1])
        # Moves cleared accumulation each frame: only the last step survives.
        assert np.asarray(app.renderer.state.accum[3]).max() <= 1.0

    def test_config5_multichip_tiled(self):
        """'multi-chip tiled render: image shards across 8 chips, per-tile
        accumulation + final gather' — via the virtual CPU mesh."""
        from l2n.parallel import ShardedRenderer, make_device_mesh
        from l2n.scene import compute_spheres
        cfg = RenderConfig(width=128, height=256, tile_width=128,
                           tile_height=32, sphere_count=8,
                           tiles_per_step=1).validate()
        mesh = make_device_mesh(8, 1)
        r = ShardedRenderer(cfg, compute_spheres(8, cfg.world_size, 0), mesh)
        cam = Camera.from_config(cfg)
        r.step(cam)
        img = r.display()  # the final gather
        assert img.shape == (256, 128, 3)
        assert np.asarray(r.state.accum)[:, 3].sum() == 8 * 32 * 128
