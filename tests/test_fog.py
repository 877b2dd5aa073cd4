"""Homogeneous-fog volumetrics (reference wishlist TODO.md 'volumetrics').

Collision (distance) sampling: each segment draws t ~ Exp(sigma_t); a
collision before the surface scatters isotropically with throughput *=
fog_albedo. Unbiasedness shows up as exact Beer-Lambert attenuation in
expectation, which is what these tests pin down.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from l2n.camera import Camera
from l2n.config import RenderConfig
from l2n.render.program import SphereProgram
from l2n.render.state import init_frame_state
from l2n.rng.sampler import ThreefrySampler, max_pairs_per_sample


def trace_rays(cfg, scene, n, seed_stream=0):
    from l2n.ops.pathtrace import trace_path
    from l2n.ops.scenes import sphere_intersector
    isect = sphere_intersector(scene)
    pix = jnp.arange(n, dtype=jnp.uint32)
    z = jnp.zeros(n, jnp.float32)
    sampler = ThreefrySampler(cfg.seed, seed_stream, pix,
                              jnp.zeros(n, jnp.uint32),
                              max_pairs_per_sample(cfg.max_bounces, cfg.nee,
                                                   cfg.fog_density > 0))
    r, g, b = trace_path(cfg, isect, sampler, z, z,
                         jnp.full(n, 10.0, jnp.float32),
                         z, z, jnp.full(n, -1.0, jnp.float32))
    return np.asarray(r)


def emissive_scene(distance, radius):
    """One emissive sphere (index 0 => emissive_every hits it) straight
    down -z at `distance` from the origin."""
    from l2n.scene import SphereScene
    return SphereScene(
        center_x=jnp.asarray([0.0], jnp.float32),
        center_y=jnp.asarray([0.0], jnp.float32),
        center_z=jnp.asarray([-float(distance)], jnp.float32),
        sqr_radius=jnp.asarray([float(radius) ** 2], jnp.float32))


class TestBeerLambert:
    @pytest.mark.parametrize("sigma", [0.002, 0.01])
    def test_absorbing_fog_attenuates_exponentially(self, sigma):
        """Pure absorption (albedo 0): the emissive sphere's observed
        radiance is L * exp(-sigma * t_hit) in expectation."""
        dist, rad = 300.0, 80.0
        scene = emissive_scene(dist, rad)
        base = RenderConfig(width=8, height=8, env_mode="none",
                            max_bounces=2, world_size=1024.0)
        n = 400_000
        clear = trace_rays(base.validate(), scene, n).mean()
        foggy = trace_rays(base.replace(fog_density=sigma,
                                        fog_albedo=0.0).validate(),
                           scene, n).mean()
        t_hit = (dist + 10.0) - rad  # ray origin at z=10 toward -z
        want = clear * np.exp(-sigma * t_hit)
        assert foggy == pytest.approx(want, rel=0.02), (foggy, want)

    def test_scattering_fog_keeps_more_energy(self):
        """With albedo 1 the medium redistributes instead of absorbing:
        radiance must exceed the absorbing case (and stay below clear)."""
        scene = emissive_scene(300.0, 80.0)
        base = RenderConfig(width=8, height=8, env_mode="none",
                            max_bounces=4, world_size=1024.0)
        n = 300_000
        clear = trace_rays(base.validate(), scene, n).mean()
        absorb = trace_rays(base.replace(fog_density=0.004,
                                         fog_albedo=0.0).validate(),
                            scene, n).mean()
        scatter = trace_rays(base.replace(fog_density=0.004,
                                          fog_albedo=1.0).validate(),
                             scene, n).mean()
        assert absorb < scatter < clear * 1.05

    def test_sky_attenuates_too(self):
        """Environment light is only reached by collision-free flights to
        the sky shell: E[sky] = sky * exp(-sigma * R_sky)."""
        from l2n.scene import compute_spheres
        scene = emissive_scene(1e7, 1.0)  # effectively empty scene
        sigma, r_sky = 0.001, 1500.0
        base = RenderConfig(width=8, height=8, env_mode="sun",
                            max_bounces=2, world_size=1024.0)
        n = 400_000
        clear = trace_rays(base.validate(), scene, n).mean()
        foggy = trace_rays(base.replace(fog_density=sigma, fog_albedo=0.0,
                                        fog_sky_distance=r_sky).validate(),
                           scene, n).mean()
        assert foggy == pytest.approx(clear * np.exp(-sigma * r_sky),
                                      rel=0.05)


class TestFogNee:
    """fog + nee: shadow rays carry the analytic exp(-sigma*d) factor
    (VERDICT r2 item 4; homogeneous transmittance is exact, no estimation)."""

    def test_shadow_transmittance_is_analytic(self):
        """nee_contribution under fog equals the fog-free contribution
        times exp(-sigma * dist-to-light-point), lane for lane."""
        from l2n.ops.nee import LightSample, nee_contribution
        from l2n.ops.scenes import sphere_intersector

        sigma = 0.004
        light_c = np.array([50.0, 200.0, -40.0], np.float32)
        light_r = 20.0
        scene = SphereSceneFromArrays([light_c], [light_r])
        isect = sphere_intersector(scene)
        n = 64
        rng = np.random.default_rng(7)
        hx = jnp.asarray(rng.uniform(-100, 100, n), jnp.float32)
        hy = jnp.zeros(n, jnp.float32)
        hz = jnp.asarray(rng.uniform(-100, 100, n), jnp.float32)
        nx = jnp.zeros(n, jnp.float32)
        ny = jnp.ones(n, jnp.float32)
        nz = jnp.zeros(n, jnp.float32)
        # A fixed (deterministic) sampled point on the light surface.
        w = np.array([0.3, 0.5, np.sqrt(1 - 0.09 - 0.25)], np.float32)
        point = light_c + light_r * w
        ones = jnp.ones(n, jnp.float32)
        light = LightSample(
            px=ones * point[0], py=ones * point[1], pz=ones * point[2],
            nx=ones * w[0], ny=ones * w[1], nz=ones * w[2],
            index=jnp.zeros(n, jnp.int32),
            r2=ones * jnp.float32(light_r ** 2))
        kd = ones * 0.7
        base = RenderConfig(width=8, height=8, env_mode="none")
        args = (1, isect, light, hx, hy, hz, nx, ny, nz,
                kd, kd, kd, ones, ones, ones)
        clear = np.asarray(nee_contribution(base.validate(), *args)[0])
        foggy = np.asarray(nee_contribution(
            base.replace(fog_density=sigma, nee=True).validate(), *args)[0])
        d = np.sqrt(((point[None, :] - np.stack(
            [np.asarray(hx), np.asarray(hy), np.asarray(hz)], 1)) ** 2
        ).sum(1))
        np.testing.assert_allclose(foggy, clear * np.exp(-sigma * d),
                                   rtol=1e-5)

    def test_nee_agrees_with_bsdf_only_under_fog(self):
        """fog+nee and fog-without-nee estimate the same transport: the
        means must agree (statistically) on a diffuse-floor + big-light
        scene inside a scattering medium."""
        light_r, floor_dist = 120.0, 300.0
        scene = SphereSceneFromArrays(
            [[0.0, 500.0, -floor_dist], [0.0, 0.0, -floor_dist - 1e4]],
            [light_r, 1e4 - 100.0])  # index 0 emissive, 1 = giant floor
        base = RenderConfig(width=8, height=8, env_mode="none",
                            max_bounces=3, fog_density=0.0008,
                            fog_albedo=0.7, world_size=1024.0)
        n = 400_000
        plain = trace_rays(base.validate(), scene, n).mean()
        withnee = trace_rays(base.replace(nee=True).validate(),
                             scene, n).mean()
        assert withnee == pytest.approx(plain, rel=0.05), (withnee, plain)

    def test_kernel_matches_oracle_with_fog_nee(self):
        cfg = RenderConfig(width=128, height=64, tile_width=128,
                           tile_height=32, sphere_count=16, tiles_per_step=2,
                           max_bounces=2, fog_density=0.002, fog_albedo=0.8,
                           nee=True).validate()
        states = []
        for backend in ("xla", "pallas"):
            prog = SphereProgram(cfg, backend=backend, interpret=True)
            st = init_frame_state(cfg)
            cam = Camera.from_config(cfg).packed()
            for _ in range(2):
                st = prog.step(st, cam)
            states.append(st)
        so, sp = states
        a, b = np.asarray(so.accum), np.asarray(sp.accum)
        assert np.sqrt(((a - b) ** 2).mean()) < 1e-3
        diff = np.abs(np.asarray(so.output) - np.asarray(sp.output))
        assert (diff > 1e-3).mean() < 1e-3


class TestFogNeeMis:
    """fog + nee + mis (the round-3 verdict's last composition cell).

    Homogeneous transmittance is a deterministic FACTOR on each strategy's
    contribution, not a pdf: NEE folds exp(-sigma*d) analytically
    (nee.py), the BSDF strategy carries it implicitly as collision-
    sampling survival, and the balance weights stay the angular pdfs —
    still summing to one, so the combination stays unbiased. The one
    asymmetry: rays scattered at a FOG vertex keep full emission weight
    (fog vertices take no NEE, so that strategy's pdf is zero there)."""

    def scene_and_cfg(self):
        light_r, floor_dist = 120.0, 300.0
        scene = SphereSceneFromArrays(
            [[0.0, 500.0, -floor_dist], [0.0, 0.0, -floor_dist - 1e4]],
            [light_r, 1e4 - 100.0])  # index 0 emissive, 1 = giant floor
        cfg = RenderConfig(width=8, height=8, env_mode="none",
                           max_bounces=3, fog_density=0.0008,
                           fog_albedo=0.7, world_size=1024.0)
        return scene, cfg

    def test_mis_agrees_with_bsdf_only_under_fog(self):
        """fog+nee+mis estimates the same transport as plain fog tracing:
        the means must agree on the diffuse-floor + big-light scene."""
        scene, base = self.scene_and_cfg()
        n = 400_000
        plain = trace_rays(base.validate(), scene, n).mean()
        withmis = trace_rays(base.replace(nee=True, mis=True).validate(),
                             scene, n).mean()
        assert withmis == pytest.approx(plain, rel=0.05), (withmis, plain)

    def test_mis_agrees_with_nee_under_fog(self):
        """...and as fog+nee-without-mis (three estimators, one answer)."""
        scene, base = self.scene_and_cfg()
        n = 400_000
        withnee = trace_rays(base.replace(nee=True).validate(),
                             scene, n).mean()
        withmis = trace_rays(base.replace(nee=True, mis=True).validate(),
                             scene, n).mean()
        assert withmis == pytest.approx(withnee, rel=0.05), (withmis, withnee)

    def test_full_weight_after_fog_vertex(self):
        """The fog-vertex full-weight rule carries real energy: zeroing
        it (simulated by comparing against a tracer where the light can
        ONLY be reached through fog scattering) must show the MIS
        estimator still finds fog->light paths. Construction: no floor,
        camera ray pointed AWAY from the light, scattering fog — every
        photon that arrives was scattered at a fog vertex first."""
        light_r = 150.0
        scene = SphereSceneFromArrays([[0.0, 0.0, 400.0]], [light_r])
        base = RenderConfig(width=8, height=8, env_mode="none",
                            max_bounces=3, fog_density=0.002,
                            fog_albedo=1.0, world_size=1024.0)
        n = 600_000
        # Rays go -z (trace_rays default); the light sits at +z.
        plain = trace_rays(base.validate(), scene, n).mean()
        withmis = trace_rays(base.replace(nee=True, mis=True).validate(),
                             scene, n).mean()
        assert plain > 0.0  # fog scattering does reach the light
        assert withmis == pytest.approx(plain, rel=0.08), (withmis, plain)

    def test_kernel_matches_oracle_with_fog_nee_mis(self):
        cfg = RenderConfig(width=128, height=64, tile_width=128,
                           tile_height=32, sphere_count=16, tiles_per_step=2,
                           max_bounces=2, fog_density=0.002, fog_albedo=0.8,
                           nee=True, mis=True).validate()
        states = []
        for backend in ("xla", "pallas"):
            prog = SphereProgram(cfg, backend=backend, interpret=True)
            st = init_frame_state(cfg)
            cam = Camera.from_config(cfg).packed()
            for _ in range(2):
                st = prog.step(st, cam)
            states.append(st)
        so, sp = states
        a, b = np.asarray(so.accum), np.asarray(sp.accum)
        assert np.sqrt(((a - b) ** 2).mean()) < 1e-3
        diff = np.abs(np.asarray(so.output) - np.asarray(sp.output))
        assert (diff > 1e-3).mean() < 1e-3


def SphereSceneFromArrays(centers, radii):
    from l2n.scene import SphereScene
    centers = np.atleast_2d(np.asarray(centers, np.float32))
    radii = np.asarray(radii, np.float32).reshape(-1)
    return SphereScene(
        center_x=jnp.asarray(centers[:, 0]),
        center_y=jnp.asarray(centers[:, 1]),
        center_z=jnp.asarray(centers[:, 2]),
        sqr_radius=jnp.asarray(radii ** 2))


class TestParity:
    def test_fog_off_is_bit_identical(self):
        """fog_density=0 must not change a single bit (the fog draws are
        gated at trace time, so the RNG stream layout is untouched)."""
        from l2n.scene import compute_spheres
        cfg = RenderConfig(width=128, height=64, tile_width=128,
                           tile_height=32, sphere_count=16,
                           tiles_per_step=2).validate()
        cfg2 = cfg.replace(fog_albedo=0.33)  # density 0: albedo is inert
        outs = []
        for c in (cfg, cfg2):
            prog = SphereProgram(c, backend="pallas", interpret=True)
            st = init_frame_state(c)
            cam = Camera.from_config(c).packed()
            for _ in range(2):
                st = prog.step(st, cam)
            outs.append(np.asarray(st.accum))
        np.testing.assert_array_equal(outs[0], outs[1])

    @pytest.mark.parametrize("mb", [1, 2])
    def test_kernel_matches_oracle_with_fog(self, mb):
        cfg = RenderConfig(width=128, height=64, tile_width=128,
                           tile_height=32, sphere_count=16, tiles_per_step=2,
                           max_bounces=mb, fog_density=0.002,
                           fog_albedo=0.8).validate()
        states = []
        for backend in ("xla", "pallas"):
            prog = SphereProgram(cfg, backend=backend, interpret=True)
            st = init_frame_state(cfg)
            cam = Camera.from_config(cfg).packed()
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

    def test_validation(self):
        with pytest.raises(ValueError, match="stateless"):
            RenderConfig(fog_density=0.1, rng="tinymt").validate()
        # fog + nee (analytic shadow transmittance) and fog + nee + mis
        # (angular balance weights; full weight after fog vertices) are
        # both supported compositions.
        RenderConfig(fog_density=0.1, nee=True).validate()
        RenderConfig(fog_density=0.1, nee=True, mis=True).validate()
        with pytest.raises(ValueError, match="emissive_every"):
            RenderConfig(fog_density=0.1, emissive_every=1).validate()
        with pytest.raises(ValueError, match="stateless"):
            RenderConfig(fog_density=0.1, rng="tauslcg").validate()
        with pytest.raises(ValueError):
            RenderConfig(fog_density=-1.0).validate()
        with pytest.raises(ValueError):
            RenderConfig(fog_albedo=1.5).validate()
        with pytest.raises(ValueError, match="fog"):
            from l2n.native.api import NativeRenderer
            from l2n.render.tiles import tile_grid
            from l2n.scene import compute_spheres
            cfg = RenderConfig(fog_density=0.1).validate()
            NativeRenderer(cfg, compute_spheres(4, 256.0, 0).as_numpy(),
                           np.asarray(tile_grid(cfg)))
