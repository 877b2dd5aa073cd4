"""Microfacet BSDF (GGX + Lambert) — reference TODO.md:5 wishlist item."""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import pytest

from l2n.config import RenderConfig
from l2n.maths.brdf import eval_brdf, procedural_roughness, sample_brdf
from l2n.maths.sampling import frame_z


def _mc_albedo(roughness, kd=1.0, n=200_000, cos_view=0.7, seed=0):
    """Monte Carlo directional albedo: E[f cos / pdf] over the sampler."""
    rng = np.random.default_rng(seed)
    u_lobe = jnp.asarray(rng.random(n, np.float32))
    u1 = jnp.asarray(rng.random(n, np.float32))
    u2 = jnp.asarray(rng.random(n, np.float32))
    z = jnp.zeros(n, jnp.float32)
    one = jnp.ones(n, jnp.float32)
    nx, ny, nzed = z, z, one
    tangent, bitangent = frame_z(nx, ny, nzed)
    s = float(np.sqrt(1.0 - cos_view ** 2))
    wox = jnp.full(n, s, jnp.float32)
    woy = z
    woz = jnp.full(n, cos_view, jnp.float32)
    k = jnp.full(n, kd, jnp.float32)
    r = jnp.full(n, roughness, jnp.float32)
    _, _, _, w_r, _, _, _ = sample_brdf(u_lobe, u1, u2, nx, ny, nzed,
                                        tangent, bitangent, wox, woy, woz,
                                        k, k, k, r)
    return float(np.asarray(w_r).mean())


class TestEnergyAndConsistency:
    @pytest.mark.parametrize("rough", [0.1, 0.4, 1.0])
    def test_white_albedo_bounded(self, rough):
        """White furnace bound: total reflectance of a kd=1 surface stays
        <= ~1 (single-scatter GGX loses a little energy at high roughness,
        never gains) and well above zero."""
        a = _mc_albedo(rough)
        assert 0.5 < a < 1.05, a

    def test_rougher_is_not_brighter_specular(self):
        """For a dark base, specular-only reflectance decreases with
        roughness (single-scattering Smith model)."""
        lo = _mc_albedo(0.1, kd=0.0)
        hi = _mc_albedo(1.0, kd=0.0)
        assert hi < lo

    def test_eval_matches_sample_weight(self):
        """w returned by sample_brdf must equal f*cos/pdf recomputed via
        eval_brdf for the same direction."""
        rng = np.random.default_rng(1)
        n = 4096
        u = [jnp.asarray(rng.random(n, np.float32)) for _ in range(3)]
        z = jnp.zeros(n, jnp.float32)
        one = jnp.ones(n, jnp.float32)
        tangent, bitangent = frame_z(z, z, one)
        wox = jnp.full(n, 0.6, jnp.float32)
        woz = jnp.full(n, 0.8, jnp.float32)
        k = jnp.full(n, 0.5, jnp.float32)
        r = jnp.full(n, 0.3, jnp.float32)
        wix, wiy, wiz, w_r, _, _, pdf = sample_brdf(
            u[0], u[1], u[2], z, z, one, tangent, bitangent,
            wox, z, woz, k, k, k, r)
        f_r, _, _, pdf2 = eval_brdf(z, z, one, wox, z, woz, wix, wiy, wiz,
                                    k, k, k, r)
        np.testing.assert_allclose(np.asarray(pdf), np.asarray(pdf2),
                                   rtol=1e-4)
        want = np.asarray(f_r) * np.maximum(np.asarray(wiz), 0) / np.maximum(
            np.asarray(pdf), 1e-12)
        got = np.asarray(w_r)
        mask = np.asarray(pdf) > 1e-6
        np.testing.assert_allclose(got[mask], want[mask], rtol=1e-3)

    def test_procedural_roughness_range(self):
        r = np.asarray(procedural_roughness(jnp.arange(128)))
        assert (r >= 0.08).all() and (r <= 1.0).all()
        assert len(np.unique(r)) > 100


class TestRenderIntegration:
    # emissive_every=2 + a camera looking at a non-emissive sphere's lit
    # face: the default camera saw ~0.1% geometry (and virtually no lit
    # surface), so the material KERNEL parity comparisons were vacuous
    # black-vs-black — the BSDF shading never gated anything.
    MAT_CFG = RenderConfig(width=128, height=64, tile_width=128,
                           tile_height=32, sphere_count=16, tiles_per_step=2,
                           emissive_every=2).validate()

    @staticmethod
    def _aimed_camera(cfg):
        from l2n.camera import Camera
        from l2n.maths.linalg import look_at
        from l2n.scene import compute_spheres
        sp = compute_spheres(cfg.sphere_count, cfg.world_size,
                             cfg.scene_seed)
        c = np.stack([np.asarray(sp.center_x), np.asarray(sp.center_y),
                      np.asarray(sp.center_z)], 1)
        r = np.sqrt(np.asarray(sp.sqr_radius))
        n = cfg.sphere_count
        odd = np.arange(1, n, 2)
        even = np.arange(0, n, 2)
        dm = np.linalg.norm(c[odd][:, None] - c[even][None], axis=2)
        oi, ei = np.unravel_index(np.argmin(dm), dm.shape)
        j, e = odd[oi], even[ei]
        to_e = c[e] - c[j]
        to_e /= np.linalg.norm(to_e)
        eye = c[j] + to_e * 5.0 * r[j]  # between light and target
        vm = look_at(eye.astype(np.float32), c[j].astype(np.float32),
                     np.array([0.0, 1.0, 0.0], np.float32))
        return Camera.from_config(cfg, view_matrix=vm)

    def _render(self, backend, cfg):
        from l2n.render.program import SphereProgram, TriangleProgram
        from l2n.render.state import init_frame_state
        cls = (SphereProgram if cfg.scene_kind == "sphere"
               else TriangleProgram)
        prog = cls(cfg, backend=backend, interpret=True)
        st = init_frame_state(cfg)
        cam = self._aimed_camera(cfg).packed()
        for _ in range(2):
            st = prog.step(st, cam)
        return np.asarray(st.accum)

    @staticmethod
    def assert_parity(a, b, flip_budget):
        """Kernel-vs-oracle gates on a LIT frame, split in two: the body of
        the image (pixels without an intersection-decision flip) must agree
        to interpret-mode precision, and the flipped pixels — the documented
        isolated silhouette/grazing divergence class — must stay a bounded
        fraction. (A single legitimate boundary flip on a path that reached
        the light moves a raw sum by the full source radiance, so any
        whole-image RMSE metric is dominated by it at low sample counts.)"""
        assert (a[:3].max(0) > 0).mean() > 0.3  # real lit coverage
        d = np.abs(a - b)
        flip = d.max(0) > 1e-3
        assert flip.mean() < flip_budget
        mean_d = np.abs(a[:3] / np.maximum(a[3], 1)
                        - b[:3] / np.maximum(b[3], 1))[:, ~flip]
        assert np.sqrt((mean_d ** 2).mean()) < 1e-3

    def test_sphere_kernel_parity_microfacet(self):
        cfg = self.MAT_CFG.replace(material_mode="microfacet")
        a = self._render("xla", cfg)
        b = self._render("pallas", cfg)
        self.assert_parity(a, b, flip_budget=2e-3)  # measured 0.009%

    def test_nee_consistency_microfacet(self):
        """NEE with the microfacet BRDF eval agrees with the BSDF-only
        estimator (both unbiased for the same scene)."""
        import tests.test_nee as tn
        base = dict(n=300_000)
        a = tn.estimate(nee=False, bounces=6, **base)

        # monkeypatch-free: reuse the harness with a microfacet config.
        import jax.numpy as jnp
        from l2n.ops.nee import make_sphere_light_sampler
        from l2n.ops.pathtrace import trace_path
        from l2n.ops.scenes import sphere_intersector
        from l2n.rng.sampler import ThreefrySampler, max_pairs_per_sample

        def run(nee, bounces, n, mis=False):
            scene = tn.make_scene()
            isect = sphere_intersector(scene)
            cx, cy, cz, r2 = (scene.center_x, scene.center_y,
                              scene.center_z, scene.sqr_radius)
            ls = make_sphere_light_sampler(
                scene.count, 16, lambda i: (cx[i], cy[i], cz[i], r2[i]))
            cfg = RenderConfig(width=8, height=8, env_mode="none",
                               max_bounces=bounces, nee=nee, mis=mis,
                               material_mode="microfacet").validate()
            pix = jnp.arange(n, dtype=jnp.uint32)
            z = jnp.zeros(n, jnp.float32)
            sampler = ThreefrySampler(0, 0, pix, jnp.zeros(n, jnp.uint32),
                                      max_pairs_per_sample(bounces, nee))
            r, _, _ = trace_path(cfg, isect, sampler, z, z,
                                 jnp.full(n, 3.0, jnp.float32), z, z,
                                 jnp.full(n, -1.0, jnp.float32),
                                 light_sampler=ls if nee else None)
            return np.asarray(r)

        mf_bsdf = run(nee=False, bounces=6, n=300_000).mean()
        mf_nee = run(nee=True, bounces=2, n=150_000).mean()
        mf_mis = run(nee=True, bounces=2, n=150_000, mis=True).mean()
        assert mf_nee == pytest.approx(mf_bsdf, rel=0.1)
        assert mf_mis == pytest.approx(mf_bsdf, rel=0.1)

    def test_config_validation(self):
        with pytest.raises(ValueError):
            RenderConfig(material_mode="phong").validate()
        RenderConfig(material_mode="disney").validate()


def _mc_albedo_disney(roughness, metallic, specular=0.5, sheen=0.0,
                      base=1.0, n=200_000, cos_view=0.7, seed=0,
                      subsurface=0.0):
    from l2n.maths.brdf import sample_disney
    rng = np.random.default_rng(seed)
    u_lobe = jnp.asarray(rng.random(n, np.float32))
    u1 = jnp.asarray(rng.random(n, np.float32))
    u2 = jnp.asarray(rng.random(n, np.float32))
    z = jnp.zeros(n, jnp.float32)
    one = jnp.ones(n, jnp.float32)
    tangent, bitangent = frame_z(z, z, one)
    s = float(np.sqrt(1.0 - cos_view ** 2))
    wox = jnp.full(n, s, jnp.float32)
    woz = jnp.full(n, cos_view, jnp.float32)
    k = jnp.full(n, base, jnp.float32)
    args = [jnp.full(n, v, jnp.float32)
            for v in (roughness, metallic, specular, sheen, subsurface)]
    _, _, _, w_r, _, _, _ = sample_disney(
        u_lobe, u1, u2, z, z, one, tangent, bitangent,
        wox, z, woz, k, k, k, *args)
    return float(np.asarray(w_r).mean())


class TestDisney:
    """Disney principled (lite) — the wishlist's named model
    (l2n-renderer/TODO.md:5 'disney bsdf')."""

    @pytest.mark.parametrize("metal", [0.0, 1.0])
    @pytest.mark.parametrize("rough", [0.15, 0.5, 1.0])
    def test_white_albedo_bounded(self, rough, metal):
        # Burley diffuse can slightly exceed 1 at grazing; the bound stays
        # near-physical. Metals lose single-scatter energy with roughness.
        a = _mc_albedo_disney(rough, metal)
        assert 0.3 < a < 1.15, a

    def test_metallic_kills_diffuse(self):
        """A black-specular metal with dark base reflects almost nothing;
        the same base as a dielectric keeps its diffuse."""
        metal_dark = _mc_albedo_disney(0.5, metallic=1.0, base=0.02)
        dielectric_dark = _mc_albedo_disney(0.5, metallic=0.0, base=0.02)
        assert metal_dark < 0.1
        assert dielectric_dark > metal_dark

    def test_sheen_adds_energy_at_grazing(self):
        lo = _mc_albedo_disney(0.5, 0.0, sheen=0.0, base=0.3, cos_view=0.15)
        hi = _mc_albedo_disney(0.5, 0.0, sheen=1.0, base=0.3, cos_view=0.15)
        assert hi > lo

    def test_eval_matches_sample_weight(self):
        from l2n.maths.brdf import eval_disney, sample_disney
        rng = np.random.default_rng(2)
        n = 4096
        u = [jnp.asarray(rng.random(n, np.float32)) for _ in range(3)]
        z = jnp.zeros(n, jnp.float32)
        one = jnp.ones(n, jnp.float32)
        tangent, bitangent = frame_z(z, z, one)
        wox = jnp.full(n, 0.6, jnp.float32)
        woz = jnp.full(n, 0.8, jnp.float32)
        k = jnp.full(n, 0.5, jnp.float32)
        pars = [jnp.full(n, v, jnp.float32)
                for v in (0.3, 0.4, 0.6, 0.5, 0.7)]
        wix, wiy, wiz, w_r, _, _, pdf = sample_disney(
            u[0], u[1], u[2], z, z, one, tangent, bitangent,
            wox, z, woz, k, k, k, *pars)
        f_r, _, _, pdf2 = eval_disney(z, z, one, wox, z, woz, wix, wiy, wiz,
                                      k, k, k, *pars)
        np.testing.assert_allclose(np.asarray(pdf), np.asarray(pdf2),
                                   rtol=1e-4)
        want = np.asarray(f_r) * np.maximum(np.asarray(wiz), 0) / np.maximum(
            np.asarray(pdf), 1e-12)
        mask = np.asarray(pdf) > 1e-6
        np.testing.assert_allclose(np.asarray(w_r)[mask], want[mask],
                                   rtol=1e-3)

    def test_eval_reciprocal(self):
        """f(wo, wi) == f(wi, wo) for every implemented lobe."""
        from l2n.maths.brdf import eval_disney
        rng = np.random.default_rng(3)
        n = 2048
        z = jnp.zeros(n, jnp.float32)
        one = jnp.ones(n, jnp.float32)

        def rand_dir():
            v = rng.normal(size=(3, n)).astype(np.float32)
            v[2] = np.abs(v[2]) + 0.05
            v /= np.linalg.norm(v, axis=0, keepdims=True)
            return [jnp.asarray(c) for c in v]

        wo = rand_dir()
        wi = rand_dir()
        k = jnp.full(n, 0.7, jnp.float32)
        pars = [jnp.full(n, v, jnp.float32)
                for v in (0.4, 0.3, 0.5, 0.8, 0.6)]
        f1 = eval_disney(z, z, one, *wo, *wi, k, k, k, *pars)[0]
        f2 = eval_disney(z, z, one, *wi, *wo, k, k, k, *pars)[0]
        np.testing.assert_allclose(np.asarray(f1), np.asarray(f2), rtol=1e-4)

    def test_subsurface_albedo_bounded(self):
        """White-furnace-style gate for the diffusion-approx lobe
        (wishlist l2n-renderer/TODO.md:17): a white full-subsurface
        dielectric stays near-physical at every tested roughness."""
        for rough in (0.15, 0.5, 1.0):
            a = _mc_albedo_disney(rough, 0.0, subsurface=1.0)
            assert 0.3 < a < 1.15, (rough, a)

    def test_subsurface_angular_signature(self):
        """The Disney ss term darkens normal incidence and brightens
        mutually grazing configurations (the 1/(n_l+n_v) transport
        factor) relative to Burley diffuse."""
        from l2n.maths.brdf import eval_disney
        z = jnp.zeros(1, jnp.float32)
        one = jnp.ones(1, jnp.float32)
        k = jnp.full(1, 0.8, jnp.float32)

        def f(cos_o, cos_i, ss):
            so = float(np.sqrt(1 - cos_o ** 2))
            si = float(np.sqrt(1 - cos_i ** 2))
            wo = (jnp.full(1, so, jnp.float32), z, jnp.full(1, cos_o,
                                                            jnp.float32))
            wi = (jnp.full(1, -si, jnp.float32), z, jnp.full(1, cos_i,
                                                             jnp.float32))
            pars = [jnp.full(1, v, jnp.float32)
                    for v in (0.5, 0.0, 0.0, 0.0, ss)]
            return float(eval_disney(z, z, one, *wo, *wi, k, k, k,
                                     *pars)[0][0])

        assert f(1.0, 1.0, 1.0) < f(1.0, 1.0, 0.0)    # flat-on: darker
        assert f(0.1, 0.1, 1.0) > f(0.1, 0.1, 0.0)    # grazing: brighter

    def test_subsurface_zero_is_burley(self):
        """subsurface=0 reproduces the pure Burley diffuse exactly (the
        pre-SSS behavior; regression gate for the blend insertion)."""
        from l2n.maths.brdf import eval_disney
        rng = np.random.default_rng(7)
        n = 512
        z = jnp.zeros(n, jnp.float32)
        one = jnp.ones(n, jnp.float32)

        def rand_dir():
            v = rng.normal(size=(3, n)).astype(np.float32)
            v[2] = np.abs(v[2]) + 0.05
            v /= np.linalg.norm(v, axis=0, keepdims=True)
            return [jnp.asarray(c) for c in v]

        wo, wi = rand_dir(), rand_dir()
        k = jnp.full(n, 0.7, jnp.float32)
        base = [jnp.full(n, v, jnp.float32) for v in (0.4, 0.3, 0.5, 0.8)]
        f0 = eval_disney(z, z, one, *wo, *wi, k, k, k, *base, z)[0]
        # Burley-only reference: fd90 retro form evaluated directly.
        nl = np.maximum(np.asarray(wi[2]), 0.0)
        nv = np.maximum(np.asarray(wo[2]), 1e-6)
        h = np.stack([np.asarray(a) + np.asarray(b)
                      for a, b in zip(wo, wi)])
        h /= np.linalg.norm(h, axis=0, keepdims=True)
        vh = np.maximum((np.stack([np.asarray(c) for c in wo]) * h).sum(0),
                        1e-6)
        s5 = lambda x: (1 - x) ** 5
        fd90 = 0.5 + 2.0 * 0.4 * vh * vh
        fd = (1 + (fd90 - 1) * s5(nl)) * (1 + (fd90 - 1) * s5(nv))
        # Subtract the (subsurface-independent) specular+sheen by
        # evaluating a black-base, sheenless, spec-only config... simpler:
        # compare f0 against f(ss=1) -- they must differ -- and against
        # the analytic Burley+spec+sheen sum via the diffuse delta.
        f1 = eval_disney(z, z, one, *wo, *wi, k, k, k, *base, one)[0]
        fss90 = 0.4 * vh * vh
        fss = (1 + (fss90 - 1) * s5(nl)) * (1 + (fss90 - 1) * s5(nv))
        ss = 1.25 * (fss * (1.0 / np.maximum(nl + nv, 1e-6) - 0.5) + 0.5)
        want_delta = 0.7 * (1 / np.pi) * (ss - fd) * (1 - 0.3) * (nl > 0)
        np.testing.assert_allclose(np.asarray(f1) - np.asarray(f0),
                                   want_delta, rtol=2e-3, atol=2e-6)

    def test_procedural_params(self):
        from l2n.maths.brdf import procedural_disney_params
        m, s, sh, ss = (np.asarray(x)
                        for x in procedural_disney_params(jnp.arange(128)))
        assert ((m >= 0) & (m <= 1)).all()
        assert ((s >= 0) & (s <= 1)).all()
        assert ((sh >= 0) & (sh <= 1)).all()
        assert ((ss >= 0) & (ss <= 1)).all()
        # A minority of objects are metals; most are pure dielectrics.
        assert 0.05 < (m > 0).mean() < 0.5
        # Roughly half the objects carry some subsurface response
        # (wishlist TODO.md:17), and the strong cases reach near 1.
        assert 0.25 < (ss > 0).mean() < 0.75
        assert ss.max() > 0.8

    def test_sphere_kernel_parity_disney(self):
        cfg = TestRenderIntegration.MAT_CFG.replace(material_mode="disney")
        t = TestRenderIntegration()
        a = t._render("xla", cfg)
        b = t._render("pallas", cfg)
        t.assert_parity(a, b, flip_budget=2e-3)

    def test_nee_consistency_disney(self):
        """NEE + MIS with the Disney eval agree with the BSDF-only
        estimator on an emissive-sphere scene."""
        import tests.test_nee as tn
        from l2n.ops.nee import make_sphere_light_sampler
        from l2n.ops.pathtrace import trace_path
        from l2n.ops.scenes import sphere_intersector
        from l2n.rng.sampler import ThreefrySampler, max_pairs_per_sample

        def run(nee, bounces, n, mis=False):
            scene = tn.make_scene()
            isect = sphere_intersector(scene)
            cx, cy, cz, r2 = (scene.center_x, scene.center_y,
                              scene.center_z, scene.sqr_radius)
            ls = make_sphere_light_sampler(
                scene.count, 16, lambda i: (cx[i], cy[i], cz[i], r2[i]))
            cfg = RenderConfig(width=8, height=8, env_mode="none",
                               max_bounces=bounces, nee=nee, mis=mis,
                               material_mode="disney").validate()
            pix = jnp.arange(n, dtype=jnp.uint32)
            z = jnp.zeros(n, jnp.float32)
            sampler = ThreefrySampler(0, 0, pix, jnp.zeros(n, jnp.uint32),
                                      max_pairs_per_sample(bounces, nee))
            r, _, _ = trace_path(cfg, isect, sampler, z, z,
                                 jnp.full(n, 3.0, jnp.float32), z, z,
                                 jnp.full(n, -1.0, jnp.float32),
                                 light_sampler=ls if nee else None)
            return float(np.asarray(r).mean())

        ref = run(nee=False, bounces=6, n=300_000)
        nee = run(nee=True, bounces=2, n=150_000)
        mis = run(nee=True, bounces=2, n=150_000, mis=True)
        assert nee == pytest.approx(ref, rel=0.1)
        assert mis == pytest.approx(ref, rel=0.1)
