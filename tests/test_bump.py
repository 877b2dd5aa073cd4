"""Procedural normal mapping (reference wishlist l2n-renderer/TODO.md:5
"Better materials (microfacet, disney bsdf, normal mapping)").

Strategy mirrors the other material features: unit-level math properties,
then three-way implementation parity (XLA oracle vs Pallas kernels vs
native C++) gated on the deterministic normal AOV, then a rendered-image
sanity check that the perturbation actually changes shading without
breaking energy bounds.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from l2n.config import RenderConfig
from l2n.maths.bump import perturb_normal, procedural_bump_amplitude


def _cfg(**kw):
    base = dict(width=128, height=64, tile_width=128, tile_height=32,
                sphere_count=16, tiles_per_step=1)
    base.update(kw)
    return RenderConfig(**base).validate()


class TestBumpMath:
    def test_result_is_unit(self):
        cfg = _cfg(normal_map=0.8)
        k = jnp.arange(64)
        px = jnp.sin(k * 0.7) * 5.0
        py = jnp.cos(k * 1.3) * 5.0
        pz = jnp.sin(k * 2.1) * 5.0
        nx = jnp.cos(k * 0.3)
        ny = jnp.sin(k * 0.3)
        nz = jnp.ones_like(px) * 0.5
        idx = (k % 16).astype(jnp.int32)
        bx, by, bz = perturb_normal(cfg, idx, px, py, pz, nx, ny, nz)
        norm = np.asarray(bx * bx + by * by + bz * bz)
        np.testing.assert_allclose(norm, 1.0, atol=1e-5)

    def test_zero_strength_is_identity(self):
        """normal_map=0 must reproduce the (normalized) input normal so the
        gated call sites stay bit-identical when disabled."""
        cfg = _cfg()  # normal_map defaults to 0
        assert cfg.normal_map == 0.0
        n = jnp.float32(1.0), jnp.float32(0.0), jnp.float32(0.0)
        bx, by, bz = perturb_normal(cfg, jnp.int32(3), jnp.float32(1.0),
                                    jnp.float32(2.0), jnp.float32(3.0), *n)
        assert float(bx) == pytest.approx(1.0) and float(by) == 0.0

    def test_amplitude_hash_range_and_spread(self):
        """Per-object amplitudes live in [0.25, 1] and actually vary (the
        same fract(sin) family as the reference's albedo hash,
        sphere_pathtracing.cs.glsl:215-222)."""
        a = np.asarray(procedural_bump_amplitude(jnp.arange(256)))
        assert a.min() >= 0.25 and a.max() <= 1.0
        assert a.std() > 0.1

    def test_perturbation_tilts_normal(self):
        cfg = _cfg(normal_map=1.0, normal_map_freq=0.35)
        k = jnp.arange(128)
        px, py, pz = k * 0.37, k * 0.91, k * 1.7
        nx = jnp.zeros_like(px)
        ny = jnp.zeros_like(px)
        nz = jnp.ones_like(px)
        bx, by, bz = perturb_normal(cfg, (k % 8).astype(jnp.int32),
                                    px, py, pz, nx, ny, nz)
        cosang = np.asarray(bz)
        assert (cosang < 1.0 - 1e-4).mean() > 0.9  # almost all tilted
        assert cosang.min() > 0.0  # but never flipped past 90 degrees


def _render(cfg, scene, backend, steps=2):
    from l2n.camera import Camera
    from l2n.render.state import init_frame_state
    from l2n.render.step import build_render_step
    step = build_render_step(cfg, scene, backend=backend, interpret=True)
    st = init_frame_state(cfg)
    cam = Camera.from_config(cfg).packed()
    for _ in range(steps):
        st = step(st, cam)
    return np.asarray(st.accum)


class TestBumpRendering:
    def scenes(self, **kw):
        from l2n.scene import compute_spheres
        cfg = _cfg(**kw)
        scene = compute_spheres(cfg.sphere_count, cfg.world_size,
                                cfg.scene_seed)
        return cfg, scene

    def test_normal_aov_perturbed_and_unit(self):
        cfg0, scene = self.scenes(aov="normal")
        cfgb, _ = self.scenes(aov="normal", normal_map=0.8)
        flat = _render(cfg0, scene, "xla")
        bump = _render(cfgb, scene, "xla")
        # plane 3 is the per-pixel sample count; actual sphere hits are the
        # pixels whose averaged normal is non-zero (miss color is black)
        hit = (flat[:3] ** 2).sum(axis=0) > 1e-6
        assert hit.mean() > 0.05
        changed = (np.abs(flat[:3] - bump[:3]).max(axis=0) > 1e-4) & hit
        assert changed.sum() > 0.5 * hit.sum()
        # perturbed AOV normals stay near-unit on hit pixels (samples are
        # jitter-averaged, so allow curvature-averaging slack)
        n = bump[:3] / np.maximum(bump[3], 1)
        norm = (n ** 2).sum(axis=0)[hit]
        assert np.quantile(norm, 0.1) > 0.9 and norm.max() < 1.01

    def test_kernel_matches_oracle_normal_aov(self):
        cfg, scene = self.scenes(aov="normal", normal_map=0.8)
        oracle = _render(cfg, scene, "xla")
        kernel = _render(cfg, scene, "pallas")
        diff = np.abs(oracle - kernel)
        assert (diff > 2e-5).mean() < 1e-3
        assert np.median(diff) == 0.0

    def test_kernel_matches_oracle_pathtracing(self):
        cfg, scene = self.scenes(normal_map=0.8)
        oracle = _render(cfg, scene, "xla")
        kernel = _render(cfg, scene, "pallas")
        np.testing.assert_array_equal(oracle[3], kernel[3])
        rmse = np.sqrt(((oracle - kernel) ** 2).mean())
        assert rmse < 1e-3, rmse

    def test_bump_changes_pathtraced_image(self):
        cfg0, scene = self.scenes()
        cfgb, _ = self.scenes(normal_map=0.8)
        flat = _render(cfg0, scene, "xla")
        bump = _render(cfgb, scene, "xla")
        assert np.isfinite(bump).all()
        assert np.abs(flat - bump).max() > 1e-3

    def test_composes_with_materials_and_nee(self):
        cfg, scene = self.scenes(normal_map=0.6, material_mode="microfacet",
                                 nee=True, env_mode="none")
        img = _render(cfg, scene, "xla")
        assert np.isfinite(img).all()
        assert img[:3].max() > 0


class TestBumpNative:
    def test_native_matches_oracle_normal_aov(self):
        import l2n.native as native
        if not native.available():
            pytest.skip("no C++ toolchain")
        from l2n.native import NativeRenderer
        from l2n.camera import Camera
        from l2n.render.state import init_frame_state
        from l2n.render.tiles import tile_grid
        from l2n.scene import compute_spheres
        cfg = _cfg(aov="normal", normal_map=0.8)
        scene = compute_spheres(cfg.sphere_count, cfg.world_size,
                                cfg.scene_seed)
        oracle = _render(cfg, scene, "xla")
        nr = NativeRenderer(cfg, scene.as_numpy(), tile_grid(cfg))
        st = init_frame_state(cfg)
        accum = np.asarray(st.accum).copy()
        output = np.asarray(st.output).copy()
        cam = Camera.from_config(cfg).packed()
        k = cfg.effective_tiles_per_step
        for i in range(2):
            nr.render_tiles(accum, output, cam,
                            offset=(i * k) % cfg.tile_count, count=k)
        # The fract(sin) amplitude hash amplifies 1-ulp libm-vs-XLA sin
        # differences by ~43758, so hit pixels agree to ~1e-4 rather than
        # exactly; gate on magnitude (miss pixels stay bit-identical).
        diff = np.abs(accum - oracle)
        assert np.sqrt((diff ** 2).mean()) < 5e-4
        assert diff.max() < 0.05
        assert np.median(diff) == 0.0

    def test_native_matches_oracle_pathtracing(self):
        import l2n.native as native
        if not native.available():
            pytest.skip("no C++ toolchain")
        from l2n.native import NativeRenderer
        from l2n.camera import Camera
        from l2n.render.state import init_frame_state
        from l2n.render.tiles import tile_grid
        from l2n.scene import compute_spheres
        cfg = _cfg(normal_map=0.8)
        scene = compute_spheres(cfg.sphere_count, cfg.world_size,
                                cfg.scene_seed)
        oracle = _render(cfg, scene, "xla")
        nr = NativeRenderer(cfg, scene.as_numpy(), tile_grid(cfg))
        st = init_frame_state(cfg)
        accum = np.asarray(st.accum).copy()
        output = np.asarray(st.output).copy()
        cam = Camera.from_config(cfg).packed()
        k = cfg.effective_tiles_per_step
        for i in range(2):
            nr.render_tiles(accum, output, cam,
                            offset=(i * k) % cfg.tile_count, count=k)
        np.testing.assert_array_equal(accum[3], oracle[3])
        rmse = np.sqrt(((accum - oracle) ** 2).mean())
        assert rmse < 1e-3, rmse
