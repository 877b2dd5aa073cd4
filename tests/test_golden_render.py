"""Golden-image regression: every implementation must keep producing the
same picture (fixed seeds, 256x128, 4 full-frame samples).

The golden accumulation was rendered by the XLA oracle; any semantic drift
in sampling, intersection, shading or scheduling across rounds shows up
here before it shows up in a judge's eye.
"""

from pathlib import Path

import numpy as np
import pytest

from l2n.camera import Camera
from l2n.config import RenderConfig
from l2n.render.state import init_frame_state
from l2n.render.step import build_render_step
from l2n.render.tiles import tile_grid
from l2n.scene import compute_spheres

GOLDEN_PATH = Path(__file__).parent / "golden" / "sphere_pt_256x128_4spp.npz"


def _load_golden(path):
    """(cfg, accum, view_matrix | None). `view_matrix` is optional in the
    npz: goldens whose default camera shows too little geometry pin an
    aimed camera instead (a near-black golden gates almost nothing —
    the round-3 sharded-triangle row_offset bug hid behind one)."""
    with np.load(path) as data:
        cfg = RenderConfig.from_json(bytes(data["config"]).decode())
        vm = data["view_matrix"] if "view_matrix" in data.files else None
        return cfg, data["accum"], vm


@pytest.fixture(scope="module")
def golden():
    return _load_golden(GOLDEN_PATH)


def render(cfg, backend, vm=None):
    scene = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    step = build_render_step(cfg, scene, backend=backend, interpret=True)
    st = init_frame_state(cfg)
    cam = Camera.from_config(cfg, view_matrix=vm).packed()
    for _ in range(4):
        st = step(st, cam)
    return np.asarray(st.accum)


class TestGoldenRender:
    def test_xla_oracle_bit_stable(self, golden):
        cfg, want, vm = golden
        got = render(cfg, "xla", vm)
        np.testing.assert_array_equal(got[3], want[3])
        d = np.abs(got - want)
        # Same backend, same seeds: tiny fp drift at most (XLA version/fusion
        # changes may wiggle decision boundaries).
        assert (d > 1e-3).mean() < 1e-3
        assert np.sqrt((d ** 2).mean()) < 1e-3

    def test_pallas_matches_golden(self, golden):
        """Cross-implementation gate: fp decision-boundary flips (compiled
        FMA fusion vs interpret) touch ~1% of values on this scene; a
        semantic bug (draw mapping, emissive rule, scheduling) moves the
        whole image. Gates sit between the two."""
        cfg, want, vm = golden
        got = render(cfg, "pallas", vm)
        np.testing.assert_array_equal(got[3], want[3])
        d = np.abs(got - want)
        assert (d > 1e-3).mean() < 0.03
        mean_diff = np.abs(got[:3] / np.maximum(got[3], 1)
                           - want[:3] / np.maximum(want[3], 1))
        assert np.sqrt((mean_diff ** 2).mean()) < 0.03

    def test_native_matches_golden(self, golden):
        import l2n.native as native
        if not native.available():
            pytest.skip("no C++ toolchain")
        from l2n.native import NativeRenderer
        cfg, want, vm = golden
        scene = compute_spheres(cfg.sphere_count, cfg.world_size,
                                cfg.scene_seed)
        nr = NativeRenderer(cfg, scene.as_numpy(), tile_grid(cfg))
        st = init_frame_state(cfg)
        accum = np.asarray(st.accum).copy()
        output = np.asarray(st.output).copy()
        cam = Camera.from_config(cfg, view_matrix=vm).packed()
        k = cfg.effective_tiles_per_step
        for i in range(4):
            nr.render_tiles(accum, output, cam,
                            offset=(i * k) % cfg.tile_count, count=k)
        np.testing.assert_array_equal(accum[3], want[3])
        d = np.abs(accum - want)
        assert (d > 1e-3).mean() < 0.03
        mean_diff = np.abs(accum[:3] / np.maximum(accum[3], 1)
                           - want[:3] / np.maximum(want[3], 1))
        assert np.sqrt((mean_diff ** 2).mean()) < 0.03


TRI_GOLDEN_PATH = Path(__file__).parent / "golden" / "triangle_pt_256x128_4spp.npz"


@pytest.fixture(scope="module")
def tri_golden():
    return _load_golden(TRI_GOLDEN_PATH)


def render_triangle(cfg, backend, vm=None):
    from l2n.scene import build_triangle_scene
    spheres = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    scene = build_triangle_scene(spheres, cfg.disc_lat, cfg.disc_long)
    step = build_render_step(cfg, scene, backend=backend, interpret=True)
    st = init_frame_state(cfg)
    cam = Camera.from_config(cfg, view_matrix=vm).packed()
    for _ in range(4):
        st = step(st, cam)
    return np.asarray(st.accum), scene


class TestTriangleGoldenRender:
    """Same golden-image gates for the second renderer family (the round-1
    suite only pinned the sphere scene)."""

    def test_xla_oracle_bit_stable(self, tri_golden):
        cfg, want, vm = tri_golden
        got, _ = render_triangle(cfg, "xla", vm)
        np.testing.assert_array_equal(got[3], want[3])
        d = np.abs(got - want)
        assert (d > 1e-3).mean() < 1e-3
        assert np.sqrt((d ** 2).mean()) < 1e-3

    def test_native_matches_golden(self, tri_golden):
        import l2n.native as native
        if not native.available():
            pytest.skip("no C++ toolchain")
        from l2n.native import NativeTriangleRenderer
        from l2n.scene import build_triangle_scene
        cfg, want, vm = tri_golden
        spheres = compute_spheres(cfg.sphere_count, cfg.world_size,
                                  cfg.scene_seed)
        scene = build_triangle_scene(spheres, cfg.disc_lat, cfg.disc_long)
        nr = NativeTriangleRenderer(cfg, scene, tile_grid(cfg))
        st = init_frame_state(cfg)
        accum = np.asarray(st.accum).copy()
        output = np.asarray(st.output).copy()
        cam = Camera.from_config(cfg, view_matrix=vm).packed()
        k = cfg.effective_tiles_per_step
        for i in range(4):
            nr.render_tiles(accum, output, cam,
                            offset=(i * k) % cfg.tile_count, count=k)
        np.testing.assert_array_equal(accum[3], want[3])
        d = np.abs(accum - want)
        assert (d > 1e-3).mean() < 0.03
        mean_diff = np.abs(accum[:3] / np.maximum(accum[3], 1)
                           - want[:3] / np.maximum(want[3], 1))
        assert np.sqrt((mean_diff ** 2).mean()) < 0.03
