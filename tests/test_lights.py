"""Explicit point/directional lights + material overrides (ops/lights.py).

The reference's declared-but-never-read light/material buffers
(sphere_pathtracing.cs.glsl:9-38, main.cpp:675-693) made live. Dirac
lights take NO RNG draws, so their contribution is deterministic — the
analytic gates here are exact up to float32, not statistical.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest

from l2n.camera import Camera
from l2n.config import RenderConfig
from l2n.maths.sampling import PI, procedural_color
from l2n.ops.lights import ExplicitLights
from l2n.ops.pathtrace import trace_path
from l2n.ops.scenes import sphere_intersector
from l2n.render.program import SphereProgram
from l2n.render.state import init_frame_state
from l2n.rng.sampler import ThreefrySampler, max_pairs_per_sample
from l2n.scene import SphereScene
from l2n.scene.materials import (
    DirectionalLights,
    PhongMaterials,
    PointLights,
)


def ground_scene():
    """Sphere 0 (emissive by index) banished to 1e7; sphere 1 = giant
    ground whose top surface sits at z=-1 with normal +z."""
    return SphereScene(
        center_x=jnp.asarray([0.0, 0.0], jnp.float32),
        center_y=jnp.asarray([0.0, 0.0], jnp.float32),
        center_z=jnp.asarray([1e7, -100.0], jnp.float32),
        sqr_radius=jnp.asarray([1.0, 99.0 ** 2], jnp.float32))


def trace(cfg, scene, lights, n=64, ox=0.0, oy=0.0, oz=3.0):
    isect = sphere_intersector(scene)
    pix = jnp.arange(n, dtype=jnp.uint32)
    z = jnp.zeros(n, jnp.float32)
    sampler = ThreefrySampler(cfg.seed, 0, pix, jnp.zeros(n, jnp.uint32),
                              max_pairs_per_sample(cfg.max_bounces, cfg.nee,
                                                   cfg.fog_density > 0))
    r, g, b = trace_path(cfg, isect, sampler,
                         jnp.full(n, ox, jnp.float32),
                         jnp.full(n, oy, jnp.float32),
                         jnp.full(n, oz, jnp.float32),
                         z, z, jnp.full(n, -1.0, jnp.float32),
                         lights=lights)
    return np.asarray(r), np.asarray(g), np.asarray(b)


def point_light(pos, intensity):
    return ExplicitLights(point_lights=PointLights.from_arrays(
        [pos], [intensity]))


class TestPointLight:
    def test_matches_closed_form_exactly(self):
        """One point light straight above a Lambert ground vertex:
        Lo = kd/pi * I * cos / d^2, deterministic (float32-exact, not
        statistical — Dirac lights draw no randoms)."""
        cfg = RenderConfig(width=8, height=8, env_mode="none",
                           max_bounces=1).validate()
        lt = point_light([0.0, 0.0, 9.0], [100.0, 100.0, 100.0])
        r, g, b = trace(cfg, ground_scene(), lt)
        kd = float(procedural_color(jnp.int32(1))[0])
        want = kd / math.pi * 100.0 * 1.0 / 10.0 ** 2  # cos=1, d=10
        np.testing.assert_allclose(r, want, rtol=1e-5)

    def test_occluded_is_exactly_zero(self):
        """A blocker between the vertex and the light zeroes the term on
        every lane (shadow rays run the full nearest-hit sweep)."""
        scene = SphereScene(
            center_x=jnp.asarray([0.0, 0.0, 0.0], jnp.float32),
            center_y=jnp.asarray([0.0, 0.0, 0.0], jnp.float32),
            center_z=jnp.asarray([1e7, -100.0, 5.0], jnp.float32),
            sqr_radius=jnp.asarray([1.0, 99.0 ** 2, 4.0], jnp.float32))
        cfg = RenderConfig(width=8, height=8, env_mode="none",
                           max_bounces=1).validate()
        lt = point_light([0.0, 0.0, 9.0], [100.0, 100.0, 100.0])
        # Camera origin z=0 (below the blocker at z in [3, 7]).
        r, _, _ = trace(cfg, scene, lt, oz=0.0)
        assert np.all(r == 0.0)

    def test_beyond_light_hit_does_not_occlude(self):
        """Geometry BEHIND the light point must not shadow it: the ground
        vertex sees the light even though the shadow direction eventually
        hits sphere 0 parked at 1e7 (t >> d)."""
        scene = SphereScene(
            center_x=jnp.asarray([0.0, 0.0], jnp.float32),
            center_y=jnp.asarray([0.0, 0.0], jnp.float32),
            center_z=jnp.asarray([1e6, -100.0], jnp.float32),
            sqr_radius=jnp.asarray([100.0, 99.0 ** 2], jnp.float32))
        cfg = RenderConfig(width=8, height=8, env_mode="none",
                           max_bounces=1).validate()
        lt = point_light([0.0, 0.0, 9.0], [100.0, 100.0, 100.0])
        r, _, _ = trace(cfg, scene, lt)
        assert np.all(r > 0.0)

    def test_fog_transmittance_is_analytic(self):
        """Under homogeneous fog the point-light term carries EXACTLY
        exp(-sigma*d) — deterministic, so equality is float-tight. Primary
        segments still collision-sample, so compare conditional on the
        un-collided lanes (identical threefry draws => same lanes)."""
        cfg = RenderConfig(width=8, height=8, env_mode="none",
                           max_bounces=1).validate()
        sigma = 0.01
        foggy_cfg = cfg.replace(fog_density=sigma, fog_albedo=0.0).validate()
        lt = point_light([0.0, 0.0, 9.0], [100.0, 100.0, 100.0])
        clear, _, _ = trace(cfg, ground_scene(), lt, n=4096)
        foggy, _, _ = trace(foggy_cfg, ground_scene(), lt, n=4096)
        surviving = foggy > 0.0  # lanes whose primary segment un-collided
        assert surviving.mean() > 0.5  # exp(-0.01*4) ~ 0.96
        np.testing.assert_allclose(foggy[surviving],
                                   clear[surviving] * np.exp(-sigma * 10.0),
                                   rtol=1e-4)


class TestDirectionalLight:
    def test_matches_closed_form_exactly(self):
        """Lo = kd/pi * E * cos for an unoccluded directional light."""
        cfg = RenderConfig(width=8, height=8, env_mode="none",
                           max_bounces=1).validate()
        s, c = math.sin(0.3), math.cos(0.3)
        lt = ExplicitLights(directional_lights=DirectionalLights.from_arrays(
            [[s, 0.0, -c]], [[2.0, 3.0, 4.0]]))  # incident dir (toward ground)
        r, g, b = trace(cfg, ground_scene(), lt)
        kd_r, kd_g, kd_b = (float(v) for v in procedural_color(jnp.int32(1)))
        np.testing.assert_allclose(r, kd_r / math.pi * 2.0 * c, rtol=1e-5)
        np.testing.assert_allclose(g, kd_g / math.pi * 3.0 * c, rtol=1e-5)
        np.testing.assert_allclose(b, kd_b / math.pi * 4.0 * c, rtol=1e-5)


class TestMaterialOverride:
    def test_albedo_override_exact(self):
        """PhongMaterials.diffuse overrides the procedural hash: the
        point-light term scales by the table value, index-keyed."""
        cfg = RenderConfig(width=8, height=8, env_mode="none",
                           max_bounces=1).validate()
        mats = PhongMaterials.from_arrays(
            [[0.1, 0.2, 0.3, 1.0], [0.5, 0.25, 0.125, 1.0]],
            [[0.0] * 3] * 2, [1.0, 1.0])
        lt = ExplicitLights(
            materials=mats,
            point_lights=PointLights.from_arrays([[0.0, 0.0, 9.0]],
                                                 [[100.0] * 3]))
        r, g, b = trace(cfg, ground_scene(), lt)  # ground = index 1
        base = 100.0 / math.pi / 100.0
        np.testing.assert_allclose(r, 0.5 * base, rtol=1e-5)
        np.testing.assert_allclose(g, 0.25 * base, rtol=1e-5)
        np.testing.assert_allclose(b, 0.125 * base, rtol=1e-5)

    def test_empty_buffers_are_bit_identical(self):
        """The reference's own state (all counts zero) must not change a
        bit — the whole feature is a trace-time gate."""
        cfg = RenderConfig(width=128, height=64, tile_width=128,
                           tile_height=32, sphere_count=16,
                           tiles_per_step=2).validate()
        outs = []
        for kw in ({}, dict(materials=None)):
            prog = SphereProgram(cfg, backend="pallas", interpret=True, **kw)
            st = init_frame_state(cfg)
            cam = Camera.from_config(cfg).packed()
            st = prog.step(st, cam)
            outs.append(np.asarray(st.accum))
        np.testing.assert_array_equal(outs[0], outs[1])


class TestKernelParity:
    @pytest.mark.parametrize("material_mode", ["procedural", "microfacet"])
    def test_sphere_kernel_matches_oracle(self, material_mode):
        cfg = RenderConfig(width=128, height=64, tile_width=128,
                           tile_height=32, sphere_count=16, tiles_per_step=2,
                           env_mode="none",
                           material_mode=material_mode).validate()
        mats = PhongMaterials.from_arrays(
            [[0.8, 0.1, 0.4, 1.0]] * 4, [[0.0] * 3] * 4, [1.0] * 4)
        kw = dict(
            materials=mats,
            point_lights=PointLights.from_arrays(
                [[0.0, 200.0, 0.0]], [[5e4] * 3]),
            directional_lights=DirectionalLights.from_arrays(
                [[0.0, -1.0, -0.3]], [[1.5, 1.0, 0.5]]))
        states = []
        for backend in ("xla", "pallas"):
            prog = SphereProgram(cfg, backend=backend, interpret=True, **kw)
            st = init_frame_state(cfg)
            cam = Camera.from_config(cfg).packed()
            for _ in range(2):
                st = prog.step(st, cam)
            states.append(st)
        a, b = np.asarray(states[0].accum), np.asarray(states[1].accum)
        assert a[:3].max() > 0.0  # the lights actually contribute
        assert np.sqrt(((a - b) ** 2).mean()) < 5e-3
        d = np.abs(a - b)
        assert (d > 1e-3).mean() < 2e-3


class TestValidation:
    def test_triangle_scene_rejects_kernel_backend(self):
        """The fused kernel renders sphere scenes only; a triangle scene
        with lights asks for the oracle explicitly instead of falling
        back silently."""
        from l2n.render.step import build_render_step
        from l2n.scene import build_triangle_scene, compute_spheres
        cfg = RenderConfig(scene_kind="triangle", sphere_count=2,
                           disc_lat=4, disc_long=4).validate()
        scene = build_triangle_scene(
            compute_spheres(2, cfg.world_size, cfg.scene_seed), 4, 4)
        lt = point_light([0.0, 0.0, 9.0], [1.0, 1.0, 1.0])
        with pytest.raises(ValueError, match="sphere scenes only"):
            build_render_step(cfg, scene, backend="pallas", lights=lt,
                              interpret=True)
