"""Sphere kernel tests.

On CPU the kernel runs through the Pallas interpreter (`interpret=True`,
always passed explicitly), which validates kernel logic, block indexing and
aliasing. The compiled Triton kernel is checked against the oracle on the
GPU by `chip_smoke.py`; here `TestTritonLowering` lowers it for CUDA, which
catches every primitive the Triton route cannot express.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from l2n.camera import Camera
from l2n.config import RenderConfig
from l2n.ops.uv_demo import uv_demo
from l2n.render.program import SphereProgram
from l2n.render.state import init_frame_state

CFG = RenderConfig(width=256, height=64, tile_width=128, tile_height=32,
                   sphere_count=32, tiles_per_step=2).validate()


def run_steps(backend, cfg=CFG, n=2):
    prog = SphereProgram(cfg, backend=backend, interpret=True)
    cam = Camera.from_config(prog.cfg).packed()
    st = init_frame_state(prog.cfg)
    for _ in range(n):
        st = prog.step(st, cam)
    return st


class TestSphereKernelParity:
    def test_matches_xla_oracle(self):
        """The fused kernel must match the full-frame oracle (dual
        implementation as oracle, SURVEY §4). On CPU interpret-mode both
        paths use identical float ops, so tolerance is tight."""
        so = run_steps("xla")
        sp = run_steps("pallas")
        np.testing.assert_array_equal(np.asarray(so.accum[3]),
                                      np.asarray(sp.accum[3]))
        a, b = np.asarray(so.accum), np.asarray(sp.accum)
        rmse = np.sqrt(((a - b) ** 2).mean())
        assert rmse < 1e-3, f"kernel/oracle RMSE {rmse}"
        # Isolated pixels may diverge where fp-op ordering flips a Russian-
        # roulette or hit/miss decision (SURVEY §7 hard part (b): parity is
        # statistical, not bitwise). Bound the fraction, not the max.
        diff = np.abs(np.asarray(so.output) - np.asarray(sp.output))
        assert (diff > 1e-3).mean() < 1e-3, f"{(diff > 1e-3).mean()} of pixels diverge"

    def test_untouched_tiles_preserved(self):
        """Aliased blocks outside the schedule must keep their contents —
        the progressive invariant (one owner per pixel per step)."""
        sp = run_steps("pallas", n=1)
        counts = np.asarray(sp.accum[3])
        assert counts.sum() == 2 * 32 * 128
        untouched = counts == 0
        assert np.asarray(sp.output)[:, untouched].max() == 0.0

    def test_offset_advances(self):
        sp = run_steps("pallas", n=3)
        assert int(sp.iteration) == 3
        assert int(sp.tile_offset) == 6 % CFG.tile_count

    def test_tinymt_kernel_matches_tinymt_oracle(self):
        """Stateful RNG plumbing through the kernel (aliased u32 planes)."""
        cfg = CFG.replace(rng="tinymt", skip_empty_tiles=False)
        so = run_steps("xla", cfg)
        sp = run_steps("pallas", cfg)
        np.testing.assert_array_equal(np.asarray(so.rng_state),
                                      np.asarray(sp.rng_state))
        a, b = np.asarray(so.accum), np.asarray(sp.accum)
        assert np.sqrt(((a - b) ** 2).mean()) < 1e-3

    def test_skip_empty_matches_no_skip(self):
        """The dead-tile cond is a pure optimization — same math, though
        wrapping in lax.cond changes fusion, so isolated RR-boundary lanes
        may flip (statistical parity, SURVEY §7(b))."""
        a = run_steps("pallas", CFG.replace(skip_empty_tiles=True))
        b = run_steps("pallas", CFG.replace(skip_empty_tiles=False))
        diff = np.abs(np.asarray(a.accum) - np.asarray(b.accum))
        assert (diff > 1e-6).mean() < 1e-3
        np.testing.assert_array_equal(np.asarray(a.accum[3]),
                                      np.asarray(b.accum[3]))

    def test_normal_aov_kernel(self):
        cfg = CFG.replace(aov="normal")
        so = run_steps("xla", cfg)
        sp = run_steps("pallas", cfg)
        np.testing.assert_allclose(np.asarray(so.accum), np.asarray(sp.accum),
                                   atol=1e-5)


class TestDisjointSceneFastPath:
    """For provably disjoint scenes the kernel's bounce/shadow sweeps drop
    the reference's t2 fallback (assume_outside — an EXACT equivalence, see
    intersect_sphere_scene); the image must still match the oracle, which
    keeps the full reference sweep."""

    def _grid_scene(self):
        import jax.numpy as jnp
        from l2n.scene import SphereScene
        from l2n.scene.spheres import spheres_disjoint
        xs = np.array([-300, -100, 100, 300] * 4, np.float32)
        ys = np.repeat([-150, -50, 50, 150], 4).astype(np.float32)
        zs = np.where(np.arange(16) % 2 == 0, -80.0, 60.0).astype(np.float32)
        scene = SphereScene(center_x=jnp.asarray(xs), center_y=jnp.asarray(ys),
                            center_z=jnp.asarray(zs),
                            sqr_radius=jnp.full((16,), 30.0 ** 2, jnp.float32))
        assert spheres_disjoint(scene, margin=1.0)
        return scene

    def test_matches_oracle(self):
        from l2n.render.state import init_frame_state as init
        cfg = CFG.replace(sphere_count=16).validate()
        scene = self._grid_scene()
        cam = Camera.from_config(cfg).packed()
        states = []
        for backend in ("xla", "pallas"):
            prog = SphereProgram(cfg, scene=scene, backend=backend,
                                 interpret=True)
            st = init(cfg)
            for _ in range(2):
                st = prog.step(st, cam)
            states.append(st)
        so, sp = states
        np.testing.assert_array_equal(np.asarray(so.accum[3]),
                                      np.asarray(sp.accum[3]))
        a, b = np.asarray(so.accum), np.asarray(sp.accum)
        assert np.sqrt(((a - b) ** 2).mean()) < 1e-3
        diff = np.abs(np.asarray(so.output) - np.asarray(sp.output))
        assert (diff > 1e-3).mean() < 1e-3

    def test_default_scene_not_disjoint(self):
        # The reference's procedural scene has overlapping pairs, so the
        # fast path must stay OFF there (the t2 fallback is live).
        from l2n.scene import compute_spheres
        from l2n.scene.spheres import spheres_disjoint
        cfg = RenderConfig().validate()
        scene = compute_spheres(128, 1024.0, cfg.scene_seed)
        assert not spheres_disjoint(scene)


class TestFastMath:
    """cfg.fast_math swaps the sphere sweeps' sqrt(disc) for
    disc * rsqrt(disc) and the normal's 1/sqrt for rsqrt (ops/intersect.py
    fast_sqrt) — final-ulp drift of the statistical parity class, threaded
    identically through the oracle and the kernels."""

    # 128 spheres so the default camera actually sees geometry — a
    # near-black frame would gate nothing (round-3 lesson).
    FM_CFG = CFG.replace(sphere_count=128)

    def test_fast_sqrt_values(self):
        from l2n.ops.intersect import fast_sqrt
        x = jnp.asarray([1e-8, 0.5, 1.0, 2.0, 1e6, 3e30], jnp.float32)
        np.testing.assert_allclose(np.asarray(fast_sqrt(x)),
                                   np.sqrt(np.asarray(x)), rtol=3e-7)
        # Negative AND exact-zero inputs poison to NaN (sqrt gives 0 at 0;
        # the sweeps treat NaN as a self-poisoned candidate either way).
        bad = np.asarray(fast_sqrt(jnp.asarray([-1.0, 0.0], jnp.float32)))
        assert np.isnan(bad).all()

    def test_fast_kernel_matches_fast_oracle(self):
        """Oracle/kernel parity must hold WITH the flag on: both sides go
        through the same intersect_sphere_scene(fast_math=True)."""
        cfg = self.FM_CFG.replace(fast_math=True)
        so = run_steps("xla", cfg)
        sp = run_steps("pallas", cfg)
        assert (np.asarray(so.accum)[:3].max(0) > 0).mean() > 0.02
        np.testing.assert_array_equal(np.asarray(so.accum[3]),
                                      np.asarray(sp.accum[3]))
        a, b = np.asarray(so.accum), np.asarray(sp.accum)
        assert np.sqrt(((a - b) ** 2).mean()) < 1e-3
        diff = np.abs(np.asarray(so.output) - np.asarray(sp.output))
        assert (diff > 1e-3).mean() < 1e-3

    @pytest.mark.parametrize("backend", ["xla", "pallas"])
    def test_fast_close_to_exact(self, backend):
        """Fast vs exact on the SAME backend: identical schedules and RNG
        draws, so the only differences are final-ulp root/normal drift and
        the measure-zero discrete flips it can cause."""
        exact = run_steps(backend, self.FM_CFG, n=2)
        fast = run_steps(backend, self.FM_CFG.replace(fast_math=True), n=2)
        np.testing.assert_array_equal(np.asarray(exact.accum[3]),
                                      np.asarray(fast.accum[3]))
        a, b = np.asarray(exact.accum), np.asarray(fast.accum)
        assert np.sqrt(((a - b) ** 2).mean()) < 1e-3
        diff = np.abs(np.asarray(exact.output) - np.asarray(fast.output))
        assert (diff > 1e-3).mean() < 1e-3


class TestStepsPerCall:
    """steps_per_call=N fuses N scheduler steps into one dispatch via
    lax.fori_loop — the image must equal N single-step calls exactly."""

    @pytest.mark.parametrize("backend", ["xla", "pallas"])
    def test_fused_equals_sequential(self, backend):
        single = run_steps(backend, CFG, n=4)
        prog = SphereProgram(CFG, backend=backend, steps_per_call=2,
                             interpret=True)
        cam = Camera.from_config(prog.cfg).packed()
        st = init_frame_state(prog.cfg)
        for _ in range(2):
            st = prog.step(st, cam)
        assert int(st.iteration) == 4
        assert int(st.tile_offset) == int(single.tile_offset)
        np.testing.assert_array_equal(np.asarray(single.accum),
                                      np.asarray(st.accum))

    def test_fused_equals_sequential_stateful(self):
        """steps_per_call must also chain the per-pixel RNG state planes
        through the fori_loop (tinymt parity mode)."""
        cfg = CFG.replace(rng="tinymt", skip_empty_tiles=False)
        single = run_steps("pallas", cfg, n=4)
        prog = SphereProgram(cfg, backend="pallas", steps_per_call=2,
                             interpret=True)
        cam = Camera.from_config(prog.cfg).packed()
        st = init_frame_state(prog.cfg)
        for _ in range(2):
            st = prog.step(st, cam)
        assert int(st.iteration) == 4
        np.testing.assert_array_equal(np.asarray(single.rng_state),
                                      np.asarray(st.rng_state))
        np.testing.assert_array_equal(np.asarray(single.accum),
                                      np.asarray(st.accum))


class TestUVDemo:
    def test_pattern(self):
        img = np.asarray(uv_demo(32, 128, 0.0))
        assert img.shape == (3, 32, 128)
        # t=0: r = 1.0 * u, g = 0.5 * v, b = 0 (uv.cs.glsl:12-20).
        np.testing.assert_allclose(img[0, 0], np.arange(128) / 128, atol=1e-6)
        np.testing.assert_allclose(img[1, :, 0], 0.5 * np.arange(32) / 32,
                                   atol=1e-6)
        assert img[2].max() == 0.0


# One 32x128 tile, 16 spheres, depth <= 2: small enough that every variant
# renders in seconds through the interpreter. emissive_every=2 and an aimed
# camera keep the frame lit (a black frame proves nothing).
SMALL = RenderConfig(width=128, height=32, tile_width=128, tile_height=32,
                     sphere_count=16, tiles_per_step=1,
                     emissive_every=2).validate()


def _aimed_parity(cfg, steps=2):
    from tests.test_brdf import TestRenderIntegration
    cam = TestRenderIntegration._aimed_camera(cfg).packed()
    states = []
    for backend in ("xla", "pallas"):
        prog = SphereProgram(cfg, backend=backend, interpret=True)
        st = init_frame_state(prog.cfg)
        for _ in range(steps):
            st = prog.step(st, cam)
        states.append(st)
    return states


class TestKernelVariants:
    """The interpreted kernel against the oracle, feature by feature: both
    trace the same ops/pathtrace.py code, so on CPU they agree to the last
    bit except where a fused reassociation flips a discrete event."""

    @pytest.mark.parametrize("rng", ["threefry", "tinymt", "tauslcg"])
    def test_rng(self, rng):
        cfg = SMALL.replace(rng=rng, skip_empty_tiles=rng == "threefry")
        so, sp = _aimed_parity(cfg)
        a, b = np.asarray(so.accum), np.asarray(sp.accum)
        assert (a[:3].max(0) > 0).mean() > 0.3
        np.testing.assert_array_equal(a[3], b[3])
        assert np.sqrt(((a - b) ** 2).mean()) < 1e-3
        if cfg.rng_stateful:
            np.testing.assert_array_equal(np.asarray(so.rng_state),
                                          np.asarray(sp.rng_state))

    @pytest.mark.parametrize("aov", ["normal", "hit", "ambient_occlusion",
                                     "tex_coords", "param_uv"])
    def test_aov(self, aov):
        so, sp = _aimed_parity(SMALL.replace(aov=aov), steps=1)
        a, b = np.asarray(so.accum), np.asarray(sp.accum)
        np.testing.assert_array_equal(a[3], b[3])
        assert (np.abs(a - b) > 1e-4).mean() < 1e-3

    @pytest.mark.parametrize("features", [
        dict(material_mode="microfacet"),
        dict(material_mode="disney"),
        dict(nee=True),
        dict(nee=True, mis=True),
        dict(fog_density=0.002),
        dict(fog_density=0.002, nee=True, mis=True),
        dict(normal_map=0.8, env_mode="sun"),
        dict(max_bounces=1),
    ], ids=lambda f: "-".join(f"{k}={v}" for k, v in f.items()))
    def test_features(self, features):
        so, sp = _aimed_parity(SMALL.replace(**features))
        a, b = np.asarray(so.accum), np.asarray(sp.accum)
        assert (a[:3].max(0) > 0).mean() > 0.02
        np.testing.assert_array_equal(a[3], b[3])
        d = np.abs(a - b)
        assert (d.max(0) > 1e-3).mean() < 2e-3

    def test_explicit_lights(self):
        from l2n.scene.materials import PointLights
        cfg = SMALL.replace(env_mode="none")
        cam = Camera.from_config(cfg).packed()
        lights = PointLights.from_arrays([[0.0, 200.0, 0.0]], [[5e4] * 3])
        accums = []
        for backend in ("xla", "pallas"):
            prog = SphereProgram(cfg, backend=backend, interpret=True,
                                 point_lights=lights)
            accums.append(np.asarray(prog.step(init_frame_state(cfg),
                                               cam).accum))
        np.testing.assert_array_equal(accums[0][3], accums[1][3])
        assert (np.abs(accums[0] - accums[1]).max(0) > 1e-3).mean() < 2e-3


class TestKernelBlocks:
    """The wrapper splits each scheduled tile into power-of-two pixel
    blocks that divide it (Triton tensors are powers of two)."""

    @pytest.mark.parametrize("tile,want", [
        ((32, 128), (16, 16)),
        ((32, 32), (16, 16)),
        ((8, 8), (8, 8)),
        ((24, 96), (8, 16)),
        ((8, 4), (8, 4)),
    ])
    def test_block_divides_tile(self, tile, want):
        from l2n.ops.kernels.sphere_pt import BLOCK_SHAPE, kernel_block
        assert BLOCK_SHAPE == (16, 16)
        cfg = RenderConfig(tile_height=tile[0], tile_width=tile[1])
        got = kernel_block(cfg)
        assert got == want
        assert tile[0] % got[0] == 0 and tile[1] % got[1] == 0

    @pytest.mark.parametrize("tile", [(32, 32), (16, 64)])
    def test_other_tile_shapes_match_oracle(self, tile):
        """Padded framebuffers (height 40 is not a tile multiple) and
        several blocks per tile: every pixel of each scheduled tile is
        written exactly once."""
        cfg = RenderConfig(width=64, height=40, tile_height=tile[0],
                           tile_width=tile[1], sphere_count=16,
                           tiles_per_step=2).validate()
        so = run_steps("xla", cfg, n=3)
        sp = run_steps("pallas", cfg, n=3)
        a, b = np.asarray(so.accum), np.asarray(sp.accum)
        np.testing.assert_array_equal(a[3], b[3])
        assert a[3].sum() == 3 * 2 * tile[0] * tile[1]
        assert np.sqrt(((a - b) ** 2).mean()) < 1e-3


class TestBackendChoice:
    """backend="auto" chooses by platform and never falls back silently."""

    @pytest.mark.parametrize("platform,scene_kind,want", [
        ("gpu", "sphere", "pallas"),
        ("gpu", "triangle", "xla"),
        ("cpu", "sphere", "xla"),
        ("cpu", "triangle", "xla"),
    ])
    def test_auto(self, monkeypatch, platform, scene_kind, want):
        from l2n.render.step import default_backend
        monkeypatch.setattr(jax, "default_backend", lambda: platform)
        assert default_backend(RenderConfig(scene_kind=scene_kind)) == want

    @pytest.mark.parametrize("platform", ["rocm", "METAL", "interpreter"])
    def test_unknown_platform_raises(self, monkeypatch, platform):
        from l2n.render.step import default_backend
        monkeypatch.setattr(jax, "default_backend", lambda: platform)
        with pytest.raises(RuntimeError, match="no render backend"):
            default_backend(RenderConfig())

    def test_program_auto_on_cpu_is_oracle(self):
        assert SphereProgram(SMALL).backend == "xla"

    def test_kernel_never_interprets_implicitly(self):
        """Without interpret=True the kernel compiles for the GPU; on the
        CPU that is an error, not a silent interpreter run."""
        prog = SphereProgram(SMALL, backend="pallas")
        cam = Camera.from_config(SMALL).packed()
        with pytest.raises(Exception, match="(?i)interpret"):
            prog.step(init_frame_state(SMALL), cam)


class TestTritonLowering:
    """Lower the kernel for CUDA on the CPU host: Pallas emits the Triton
    IR here and XLA compiles it only on the GPU, so every primitive the
    Triton route lacks fails in this test rather than on the card."""

    @pytest.mark.parametrize("features", [
        dict(),
        dict(fast_math=True),
        dict(rng="tinymt", skip_empty_tiles=False),
        dict(rng="tauslcg"),
        dict(nee=True, mis=True, fog_density=0.001),
        dict(material_mode="disney", normal_map=0.5),
        dict(aov="ambient_occlusion"),
    ], ids=lambda f: "-".join(f"{k}={v}" for k, v in f.items()) or "base")
    def test_lowers_to_triton(self, features):
        from l2n.render.step import build_render_step
        from l2n.scene import compute_spheres
        cfg = RenderConfig(width=256, height=64, sphere_count=128,
                           tiles_per_step=4, spp_per_step=2,
                           **features).validate()
        scene = compute_spheres(cfg.sphere_count, cfg.world_size,
                                cfg.scene_seed)
        step = build_render_step(cfg, scene, backend="pallas")
        state = jax.eval_shape(lambda: init_frame_state(cfg))
        cam = Camera.from_config(cfg).packed()
        text = step.trace(state, cam).lower(
            lowering_platforms=("cuda",)).as_text()
        assert "__gpu$xla.gpu.triton" in text


def test_default_block_is_two_pixels_per_thread():
    """The shipped block shape (the fastest measured, PERF.md) keeps the
    per-pixel path state of two pixels in each thread's registers."""
    from l2n.ops.kernels.sphere_pt import BLOCK_SHAPE, NUM_WARPS
    assert BLOCK_SHAPE[0] * BLOCK_SHAPE[1] == 2 * 32 * NUM_WARPS
