"""Native C++ tier tests: build, RNG bit-parity, renderer-vs-oracle parity.

The native renderer is the framework's third independent implementation of
the pipeline (scalar C++ with a thread pool, mirroring the reference's
CPUSpherePathtracing, src/main.cpp:206-599); these tests close the
triangle: golden vectors <-> JAX <-> C++.
"""

import json
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest

import l2n.native as native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C++ toolchain")

GOLDEN = json.loads(
    (Path(__file__).parent / "golden" / "tinymt32_vectors.json").read_text())



def aimed_at_sphere0(cfg):
    """Camera looking at the emissive sphere (index 0) up close — the
    default camera sees ~0.1% geometry on small tessellated configs, and a
    near-black parity comparison gates almost nothing."""
    from l2n.camera import Camera
    from l2n.maths.linalg import look_at
    from l2n.scene import compute_spheres
    sp = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    c0 = np.array([float(sp.center_x[0]), float(sp.center_y[0]),
                   float(sp.center_z[0])], np.float32)
    r0 = float(np.sqrt(float(sp.sqr_radius[0])))
    vm = look_at(c0 + np.array([0.0, 0.0, 2.5 * r0], np.float32), c0,
                 np.array([0.0, 1.0, 0.0], np.float32))
    return Camera.from_config(cfg, view_matrix=vm)

class TestNativeRng:
    def test_tinymt_matches_golden(self):
        from l2n.native import tinymt_uint32_native
        for case in GOLDEN:
            got = tinymt_uint32_native(case["mat1"], case["mat2"],
                                       case["tmat"], case["seed"],
                                       len(case["uint32"]))
            assert got.tolist() == case["uint32"]

    def test_threefry_matches_jax(self):
        from l2n.native import threefry2x32_native
        from l2n.rng.threefry import threefry2x32
        x0 = np.arange(64, dtype=np.uint32)
        x1 = np.arange(64, dtype=np.uint32)[::-1].copy()
        n0, n1 = threefry2x32_native(42, 7, x0, x1)
        j0, j1 = threefry2x32(jnp.uint32(42), jnp.uint32(7),
                              jnp.asarray(x0), jnp.asarray(x1))
        np.testing.assert_array_equal(n0, np.asarray(j0))
        np.testing.assert_array_equal(n1, np.asarray(j1))


class TestNativeRenderer:
    def make(self, rng="threefry", aov="pathtracing", **cfg_kw):
        from l2n.config import RenderConfig
        from l2n.native import NativeRenderer
        from l2n.render.tiles import tile_grid
        from l2n.scene import compute_spheres

        cfg = RenderConfig(width=128, height=64, tile_width=128,
                           tile_height=32, sphere_count=16, tiles_per_step=1,
                           rng=rng, aov=aov, **cfg_kw).validate()
        scene = compute_spheres(cfg.sphere_count, cfg.world_size,
                                cfg.scene_seed)
        tiles = tile_grid(cfg)
        return cfg, scene, NativeRenderer(cfg, scene.as_numpy(), tiles)

    def run_native(self, cfg, nr, steps=2, cam=None):
        from l2n.camera import Camera
        from l2n.render.state import init_frame_state
        st = init_frame_state(cfg)
        accum = np.asarray(st.accum).copy()
        output = np.asarray(st.output).copy()
        rng_state = (np.asarray(st.rng_state).copy()
                     if st.rng_state is not None else None)
        if cam is None:
            cam = Camera.from_config(cfg).packed()
        k = cfg.effective_tiles_per_step
        for i in range(steps):
            nr.render_tiles(accum, output, cam, offset=(i * k) % cfg.tile_count,
                            count=k, rng_state=rng_state)
        return accum, output

    def run_oracle(self, cfg, scene, steps=2, cam=None):
        from l2n.camera import Camera
        from l2n.render.step import build_render_step
        from l2n.render.state import init_frame_state
        step = build_render_step(cfg, scene, backend="xla")
        st = init_frame_state(cfg)
        if cam is None:
            cam = Camera.from_config(cfg).packed()
        for _ in range(steps):
            st = step(st, cam)
        return np.asarray(st.accum), np.asarray(st.output)

    def test_matches_oracle_microfacet(self):
        """Third implementation of the microfacet wishlist material: the
        C++ twin of brdf.py (same formulas, same draw order) on a LIT
        aimed frame (see test_brdf: the default camera sees almost no lit
        surface, which would gate nothing)."""
        from tests.test_brdf import TestRenderIntegration
        cfg, scene, nr = self.make(material_mode="microfacet",
                                   emissive_every=2)
        cam = TestRenderIntegration._aimed_camera(cfg).packed()
        na, no = self.run_native(cfg, nr, cam=cam)
        ja, jo = self.run_oracle(cfg, scene, cam=cam)
        assert (ja[:3].max(0) > 0).mean() > 0.3  # real lit coverage
        np.testing.assert_array_equal(na[3], ja[3])  # same coverage
        d = np.abs(na - ja)
        flip = d.max(0) > 1e-3
        assert flip.mean() < 8e-3  # isolated decision-boundary class
        body = np.abs(na[:3] / np.maximum(na[3], 1)
                      - ja[:3] / np.maximum(ja[3], 1))[:, ~flip]
        assert np.sqrt((body ** 2).mean()) < 1e-3

    def test_matches_oracle_disney(self):
        """Native Disney(lite) twin — Burley + subsurface blend + sheen +
        colored-Fresnel GGX with metallic-weighted mixture sampling — on
        the lit aimed frame."""
        from tests.test_brdf import TestRenderIntegration
        cfg, scene, nr = self.make(material_mode="disney",
                                   emissive_every=2)
        cam = TestRenderIntegration._aimed_camera(cfg).packed()
        na, no = self.run_native(cfg, nr, cam=cam)
        ja, jo = self.run_oracle(cfg, scene, cam=cam)
        assert (ja[:3].max(0) > 0).mean() > 0.3
        np.testing.assert_array_equal(na[3], ja[3])
        d = np.abs(na - ja)
        flip = d.max(0) > 1e-3
        assert flip.mean() < 8e-3
        body = np.abs(na[:3] / np.maximum(na[3], 1)
                      - ja[:3] / np.maximum(ja[3], 1))[:, ~flip]
        assert np.sqrt((body ** 2).mean()) < 1e-3

    def test_matches_oracle_threefry(self):
        """Same threefry draw addressing + same math => near-identical
        images; residual is fp-ordering noise at decision boundaries."""
        cfg, scene, nr = self.make()
        na, no = self.run_native(cfg, nr)
        ja, jo = self.run_oracle(cfg, scene)
        np.testing.assert_array_equal(na[3], ja[3])  # same coverage
        rmse = np.sqrt(((na - ja) ** 2).mean())
        assert rmse < 1e-3, f"native/oracle RMSE {rmse}"
        assert (np.abs(no - jo) > 1e-3).mean() < 2e-3

    def test_matches_oracle_normal_aov(self):
        """Deterministic AOV: tight parity except silhouette-edge pixels
        where fp rounding flips a grazing hit."""
        cfg, scene, nr = self.make(aov="normal")
        na, no = self.run_native(cfg, nr)
        ja, jo = self.run_oracle(cfg, scene)
        diff = np.abs(na - ja)
        assert (diff > 2e-5).mean() < 1e-3
        assert np.median(diff) == 0.0

    def test_tinymt_mode_runs(self):
        cfg, scene, nr = self.make(rng="tinymt")
        na, no = self.run_native(cfg, nr)
        assert na[3].sum() == 2 * 32 * 128
        assert np.isfinite(no).all()

    def test_multithreaded_deterministic(self):
        """The atomic tile queue must not change results (one owner per
        pixel per step — SURVEY §5 race-detection invariant)."""
        cfg, scene, nr1 = self.make()
        from l2n.native import NativeRenderer
        from l2n.render.tiles import tile_grid
        nr2 = NativeRenderer(cfg, scene.as_numpy(), tile_grid(cfg),
                             num_threads=1)
        a1, o1 = self.run_native(cfg, nr1)
        a2, o2 = self.run_native(cfg, nr2)
        np.testing.assert_array_equal(a1, a2)


class TestNativeNEE:
    def test_nee_matches_oracle(self):
        """Triple-implementation coverage for NEE: native C++ vs the JAX
        oracle with identical threefry draw addressing (including the
        draw1 sibling-caching order)."""
        if not native.available():
            pytest.skip("no C++ toolchain")
        from l2n.camera import Camera
        from l2n.config import RenderConfig
        from l2n.native import NativeRenderer
        from l2n.render.state import init_frame_state
        from l2n.render.step import build_render_step
        from l2n.render.tiles import tile_grid
        from l2n.scene import compute_spheres

        cfg = RenderConfig(width=128, height=64, tile_width=128,
                           tile_height=32, sphere_count=32, tiles_per_step=2,
                           nee=True, env_mode="none").validate()
        scene = compute_spheres(cfg.sphere_count, cfg.world_size,
                                cfg.scene_seed)
        # oracle
        step = build_render_step(cfg, scene, backend="xla")
        st = init_frame_state(cfg)
        cam = Camera.from_config(cfg).packed()
        for _ in range(2):
            st = step(st, cam)
        oracle = np.asarray(st.accum)
        # native
        nr = NativeRenderer(cfg, scene.as_numpy(), tile_grid(cfg))
        st0 = init_frame_state(cfg)
        accum = np.asarray(st0.accum).copy()
        output = np.asarray(st0.output).copy()
        k = cfg.effective_tiles_per_step
        for i in range(2):
            nr.render_tiles(accum, output, cam,
                            offset=(i * k) % cfg.tile_count, count=k)
        np.testing.assert_array_equal(accum[3], oracle[3])
        d = np.abs(accum - oracle)
        assert np.sqrt((d ** 2).mean()) < 5e-3, d.max()
        assert (d > 1e-3).mean() < 2e-3


class TestNativeTriangleRenderer:
    """Native C++ triangle renderer — r1 VERDICT next item 7 (the
    reference's CPU renderer is sphere-only; three independent
    implementations must cover BOTH scene families)."""

    def make(self, aov="pathtracing", **cfg_kw):
        from l2n.config import RenderConfig
        from l2n.native import NativeTriangleRenderer
        from l2n.render.tiles import tile_grid
        from l2n.scene import build_triangle_scene, compute_spheres

        cfg = RenderConfig(width=128, height=64, tile_width=128,
                           tile_height=32, sphere_count=8, disc_lat=8,
                           disc_long=4, tiles_per_step=1, aov=aov,
                           scene_kind="triangle", **cfg_kw).validate()
        spheres = compute_spheres(cfg.sphere_count, cfg.world_size,
                                  cfg.scene_seed)
        scene = build_triangle_scene(spheres, cfg.disc_lat, cfg.disc_long)
        tiles = tile_grid(cfg)
        return cfg, scene, NativeTriangleRenderer(cfg, scene, tiles)

    def run_native(self, cfg, nr, steps=2, cam=None):
        from l2n.camera import Camera
        from l2n.render.state import init_frame_state
        st = init_frame_state(cfg)
        accum = np.asarray(st.accum).copy()
        output = np.asarray(st.output).copy()
        if cam is None:
            cam = Camera.from_config(cfg).packed()
        k = cfg.effective_tiles_per_step
        for i in range(steps):
            nr.render_tiles(accum, output, cam,
                            offset=(i * k) % cfg.tile_count, count=k)
        return accum, output

    def run_oracle(self, cfg, scene, steps=2, cam=None):
        from l2n.camera import Camera
        from l2n.render.state import init_frame_state
        from l2n.render.step import build_render_step
        step = build_render_step(cfg, scene, backend="xla")
        st = init_frame_state(cfg)
        if cam is None:
            cam = Camera.from_config(cfg).packed()
        for _ in range(steps):
            st = step(st, cam)
        return np.asarray(st.accum), np.asarray(st.output)

    def test_matches_oracle_microfacet(self):
        """Native microfacet on the tessellated-mesh family: the same C++
        BSDF twin shading about the normalized interpolated normal, on a
        lit aimed frame (the default camera sees ~0.1% geometry here)."""
        if not native.available():
            pytest.skip("no C++ toolchain")
        cfg, scene, nr = self.make(material_mode="microfacet",
                                   emissive_every=2)
        cam = aimed_at_sphere0(cfg).packed()
        na, no = self.run_native(cfg, nr, cam=cam)
        ja, jo = self.run_oracle(cfg, scene, cam=cam)
        assert (ja[:3].max(0) > 0).mean() > 0.3  # real lit coverage
        np.testing.assert_array_equal(na[3], ja[3])
        d = np.abs(na - ja)
        flip = d.max(0) > 1e-3
        assert flip.mean() < 8e-3
        body = np.abs(na[:3] / np.maximum(na[3], 1)
                      - ja[:3] / np.maximum(ja[3], 1))[:, ~flip]
        assert np.sqrt((body ** 2).mean()) < 1e-3

    def test_matches_oracle_threefry(self):
        if not native.available():
            pytest.skip("no C++ toolchain")
        cfg, scene, nr = self.make()
        na, no = self.run_native(cfg, nr)
        ja, jo = self.run_oracle(cfg, scene)
        np.testing.assert_array_equal(na[3], ja[3])
        rmse = np.sqrt(((na - ja) ** 2).mean())
        assert rmse < 1e-3, f"native/oracle RMSE {rmse}"
        assert (np.abs(no - jo) > 1e-3).mean() < 2e-3

    def test_matches_oracle_normal_aov(self):
        if not native.available():
            pytest.skip("no C++ toolchain")
        cfg, scene, nr = self.make(aov="normal")
        na, no = self.run_native(cfg, nr)
        ja, jo = self.run_oracle(cfg, scene)
        diff = np.abs(na - ja)
        assert (diff > 2e-5).mean() < 1e-3
        assert np.median(diff) == 0.0

    def test_nee_matches_oracle(self):
        """Cone NEE three-way coverage (r2 VERDICT next item 8): native C++
        vs the JAX oracle with identical threefry draw addressing over the
        emissive meshes' bounding-sphere cones (ops/nee.py)."""
        if not native.available():
            pytest.skip("no C++ toolchain")
        from l2n.config import RenderConfig
        from l2n.native import NativeTriangleRenderer
        from l2n.camera import Camera
        from l2n.render.state import init_frame_state
        from l2n.render.tiles import tile_grid
        from l2n.scene import build_triangle_scene, compute_spheres
        cfg = RenderConfig(width=128, height=64, tile_width=128,
                           tile_height=32, sphere_count=16, disc_lat=8,
                           disc_long=4, tiles_per_step=2, nee=True,
                           env_mode="none",
                           scene_kind="triangle").validate()
        spheres = compute_spheres(cfg.sphere_count, cfg.world_size,
                                  cfg.scene_seed)
        scene = build_triangle_scene(spheres, cfg.disc_lat, cfg.disc_long)
        ja, _jo = self.run_oracle(cfg, scene)
        nr = NativeTriangleRenderer(cfg, scene, tile_grid(cfg))
        st = init_frame_state(cfg)
        accum = np.asarray(st.accum).copy()
        output = np.asarray(st.output).copy()
        cam = Camera.from_config(cfg).packed()
        k = cfg.effective_tiles_per_step
        for i in range(2):
            nr.render_tiles(accum, output, cam,
                            offset=(i * k) % cfg.tile_count, count=k)
        np.testing.assert_array_equal(accum[3], ja[3])
        d = np.abs(accum - ja)
        # Cone sampling constantly aims at the light bound's silhouette, so
        # a handful of shadow rays land exactly on triangle-edge decisions
        # where independent fp stacks (XLA vs scalar C++) can flip hit/miss
        # — each flip carries one sample's full O(1) cone weight. Gate on
        # the FLIP COUNT and the agreement of everything else, not RMSE.
        assert np.median(d) == 0.0
        assert (d > 1e-3).mean() < 2e-4      # near-universal agreement
        assert (d > 0.05).mean() < 1.5e-4    # <= ~2 flipped pixels
