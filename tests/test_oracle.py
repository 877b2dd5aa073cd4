"""Semantics tests for the path tracer core: intersections, env lights,
ray-gen, the masked bounce loop (reference kernels sphere_pathtracing.cs.glsl
/ triangle_pathtracing.cs.glsl)."""

import numpy as np
import jax.numpy as jnp
import pytest

from l2n.camera import Camera
from l2n.config import RenderConfig
from l2n.maths.linalg import look_at
from l2n.maths.sampling import PI, procedural_color
from l2n.ops.envlight import mandelbrot_le, sun_le
from l2n.ops.intersect import intersect_sphere_scene, intersect_triangle_scene
from l2n.ops.pathtrace import generate_rays, shade, trace_path
from l2n.ops.scenes import sphere_intersector, triangle_intersector
from l2n.rng.sampler import ThreefrySampler, max_pairs_per_sample
from l2n.scene import SphereScene, build_triangle_scene, compute_spheres


def make_sphere_scene(data):
    data = np.asarray(data, np.float32)
    return SphereScene(center_x=jnp.asarray(data[:, 0]),
                       center_y=jnp.asarray(data[:, 1]),
                       center_z=jnp.asarray(data[:, 2]),
                       sqr_radius=jnp.asarray(data[:, 3] ** 2))


def sampler_for(shape, seed=0, max_bounces=2):
    pix = jnp.arange(int(np.prod(shape)), dtype=jnp.uint32).reshape(shape)
    return ThreefrySampler(seed, 0, pix, jnp.zeros(shape, jnp.uint32),
                           max_pairs_per_sample(max_bounces))


class TestSphereIntersect:
    def test_direct_hit(self):
        scene = make_sphere_scene([[0, 0, -10, 2]])
        isect = sphere_intersector(scene)
        h = isect(*(jnp.float32(v) for v in (0, 0, 0, 0, 0, -1)))
        assert float(h.t) == pytest.approx(8.0, abs=1e-4)
        assert float(h.nz) == pytest.approx(1.0, abs=1e-5)
        assert int(h.index) == 0
        assert float(h.emis_r2) == pytest.approx(4.0)

    def test_from_inside_takes_far_root(self):
        """t = t1 if t1 >= 0 else t2 (glsl:157): origin inside hits backside."""
        scene = make_sphere_scene([[0, 0, 0, 3]])
        isect = sphere_intersector(scene)
        h = isect(*(jnp.float32(v) for v in (0, 0, 0, 0, 0, -1)))
        assert float(h.t) == pytest.approx(3.0, abs=1e-4)
        assert float(h.nz) == pytest.approx(-1.0, abs=1e-5)

    def test_nearest_wins(self):
        scene = make_sphere_scene([[0, 0, -20, 2], [0, 0, -10, 2], [0, 0, -30, 2]])
        isect = sphere_intersector(scene)
        h = isect(*(jnp.float32(v) for v in (0, 0, 0, 0, 0, -1)))
        assert int(h.index) == 1
        assert float(h.t) == pytest.approx(8.0, abs=1e-4)

    def test_miss_sentinel(self):
        scene = make_sphere_scene([[0, 0, -10, 2]])
        isect = sphere_intersector(scene)
        h = isect(*(jnp.float32(v) for v in (0, 0, 0, 0, 0, 1)))
        assert float(h.t) == -1.0
        assert int(h.index) == -1

    def test_behind_ray_is_miss(self):
        scene = make_sphere_scene([[0, 0, 10, 2]])
        isect = sphere_intersector(scene)
        h = isect(*(jnp.float32(v) for v in (0, 0, 0, 0, 0, -1)))
        assert float(h.t) < 0

    def test_batched(self):
        scene = make_sphere_scene([[0, 0, -10, 2]])
        isect = sphere_intersector(scene)
        dz = jnp.asarray([-1.0, 1.0], jnp.float32)
        z = jnp.zeros(2, jnp.float32)
        h = isect(z, z, z, z, z, dz)
        np.testing.assert_allclose(np.asarray(h.t), [8.0, -1.0], atol=1e-4)


class TestTriangleIntersect:
    def soup_one(self, v1, v2, v3):
        v1, v2, v3 = (np.asarray(v, np.float32) for v in (v1, v2, v3))
        soup = {}
        for n, val in (("v1", v1), ("e1", v2 - v1), ("e2", v3 - v1)):
            for k, ax in enumerate("xyz"):
                soup[f"{n}{ax}"] = jnp.asarray([val[k]])
        for stem in ("na", "nb", "nc"):
            for k, ax in enumerate("xyz"):
                soup[f"{stem}{ax}"] = jnp.asarray([0.0 if ax != "z" else 1.0],
                                                  jnp.float32)
        for stem, val in (("ta", (0.0, 0.0)), ("tb", (1.0, 0.0)), ("tc", (0.0, 1.0))):
            soup[f"{stem}u"] = jnp.asarray([val[0]], jnp.float32)
            soup[f"{stem}v"] = jnp.asarray([val[1]], jnp.float32)
        soup["mesh_id"] = jnp.asarray([0], jnp.int32)
        return soup

    def test_hit_barycentrics(self):
        soup = self.soup_one([0, 0, -5], [2, 0, -5], [0, 2, -5])
        isect = triangle_intersector(soup)
        # Aim at (0.5, 0.5, -5): u (towards v2) = 0.25, v = 0.25.
        d = np.array([0.5, 0.5, -5.0]); d /= np.linalg.norm(d)
        h = isect(*(jnp.float32(v) for v in (0, 0, 0, d[0], d[1], d[2])))
        assert float(h.t) == pytest.approx(np.linalg.norm([0.5, 0.5, 5.0]), rel=1e-4)
        assert float(h.b_u) == pytest.approx(0.25, abs=1e-5)
        assert float(h.b_v) == pytest.approx(0.25, abs=1e-5)
        assert float(h.tc_u) == pytest.approx(0.25, abs=1e-5)
        assert int(h.index) == 0

    def test_outside_misses(self):
        soup = self.soup_one([0, 0, -5], [2, 0, -5], [0, 2, -5])
        isect = triangle_intersector(soup)
        d = np.array([1.5, 1.5, -5.0]); d /= np.linalg.norm(d)  # u+v > 1
        h = isect(*(jnp.float32(v) for v in (0, 0, 0, d[0], d[1], d[2])))
        assert float(h.t) == -1.0

    def test_parallel_ray_misses(self):
        soup = self.soup_one([0, 0, -5], [2, 0, -5], [0, 2, -5])
        isect = triangle_intersector(soup)
        h = isect(*(jnp.float32(v) for v in (0, 0, 0, 1, 0, 0)))
        assert float(h.t) == -1.0

    def test_tessellated_sphere_matches_analytic(self):
        """A finely tessellated sphere must intersect ≈ like the analytic one
        (the reference's two renderers draw the same scene)."""
        spheres = compute_spheres(1, 64.0, seed=3)
        tri = build_triangle_scene(spheres, 32, 16)
        t_isect = triangle_intersector(tri.soup())
        s_isect = sphere_intersector(spheres)
        cx = float(spheres.center_x[0]); cy = float(spheres.center_y[0])
        cz = float(spheres.center_z[0])
        org = np.array([cx, cy, cz + 50.0], np.float32)
        d = np.array([0.0, 0.0, -1.0], np.float32)
        args = [jnp.float32(v) for v in (*org, *d)]
        ht = t_isect(*args)
        hs = s_isect(*args)
        assert float(ht.t) == pytest.approx(float(hs.t), rel=2e-2)
        assert float(ht.nz) == pytest.approx(1.0, abs=0.05)


class TestEnvLights:
    def test_mandelbrot_against_numpy(self, rng):
        """Independent scalar numpy implementation as oracle."""
        def scalar_mandelbrot(d):
            cos_t, sin_t = d[2], np.hypot(d[0], d[1])
            theta, phi = np.arctan2(sin_t, cos_t), np.arctan2(d[1], d[0])
            u, v = phi / np.pi, -1 + 2 * theta / np.pi
            p = np.array([8 * u, 4 * v], np.float32)
            z = np.zeros(2, np.float32)
            for i in range(64):
                z = np.array([z[0] ** 2 - z[1] ** 2, 2 * z[0] * z[1]],
                             np.float32) + p
                if z @ z > 4:
                    return i / 64.0
            return 0.0

        d = rng.normal(size=(64, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        got = np.asarray(mandelbrot_le(*(jnp.asarray(d[:, i]) for i in range(3))))
        want = np.array([scalar_mandelbrot(di) for di in d], np.float32)
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert (want > 0).any() and (want == 0).any()  # non-trivial directions

    def test_sun_peak_and_falloff(self):
        s = 1.0 / np.sqrt(3.0)
        peak = float(sun_le(jnp.float32(s), jnp.float32(s), jnp.float32(-s)))
        assert peak == pytest.approx(1.0, abs=1e-4)
        off = float(sun_le(jnp.float32(-s), jnp.float32(-s), jnp.float32(s)))
        assert off == 0.0
        # pow(d, 128) falloff.
        d = np.float32(0.99)
        got = float(sun_le(jnp.float32(s * d), jnp.float32(s * d),
                           jnp.float32(-s * d)))
        assert got == pytest.approx(d ** 128 * (d ** 128 / d ** 128), rel=1e-2) or got > 0


class TestRayGen:
    def cam(self, cfg):
        return jnp.asarray(Camera.from_config(cfg).packed())

    def test_center_pixel_points_forward(self):
        cfg = RenderConfig(width=64, height=64).validate()
        cam = Camera(view_matrix=np.eye(4, dtype=np.float32),
                     aspect_ratio=1.0, fovy_deg=45.0)
        px = jnp.float32(31.5); py = jnp.float32(31.5)
        half = jnp.float32(0.5)
        ox, oy, oz, dx, dy, dz = generate_rays(
            cfg, jnp.asarray(cam.packed()), px, py, half, half)
        assert float(dz) == pytest.approx(-1.0, abs=1e-5)
        assert float(ox) == 0.0

    def test_fovy_matches_viewproj(self, rng):
        """Both reference ray-gen variants must produce the same rays
        (glsl:380's comment claims equivalence)."""
        cfg_a = RenderConfig(width=128, height=96, ray_gen="fovy").validate()
        cfg_b = cfg_a.replace(ray_gen="viewproj")
        cam = jnp.asarray(Camera.from_config(cfg_a).packed())
        px = jnp.asarray(rng.integers(0, 128, 50).astype(np.float32))
        py = jnp.asarray(rng.integers(0, 96, 50).astype(np.float32))
        u = jnp.asarray(rng.random(50, dtype=np.float32))
        v = jnp.asarray(rng.random(50, dtype=np.float32))
        ra = generate_rays(cfg_a, cam, px, py, u, v)
        rb = generate_rays(cfg_b, cam, px, py, u, v)
        for a, b in zip(ra[3:], rb[3:]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-3)


class TestTracePath:
    def cfg(self, **kw):
        base = dict(width=8, height=8, env_mode="none", max_bounces=2)
        base.update(kw)
        return RenderConfig(**base).validate()

    def trace_one(self, cfg, scene_rows, org, d):
        isect = sphere_intersector(make_sphere_scene(scene_rows))
        sampler = sampler_for((), seed=5, max_bounces=cfg.max_bounces)
        args = [jnp.float32(v) for v in (*org, *d)]
        return [float(c) for c in trace_path(cfg, isect, sampler, *args)]

    def test_emissive_direct(self):
        """Index 0 is emissive: color = scale / (4 pi r^2), no env, no
        bounce (glsl:285-290)."""
        cfg = self.cfg(env_mode="sun")
        r = 2.0
        got = self.trace_one(cfg, [[0, 0, -10, r]], (0, 0, 0), (0, 0, -1))
        expect = 8192.0 / (4 * PI * r * r)
        np.testing.assert_allclose(got, [expect] * 3, rtol=1e-5)

    def test_pure_miss_gets_env(self):
        cfg = self.cfg(env_mode="sun")
        s = 1 / np.sqrt(3)
        got = self.trace_one(cfg, [[0, 0, -1000, 1]], (0, 0, 0), (s, s, -s))
        np.testing.assert_allclose(got, [3.0] * 3, rtol=1e-4)  # 3 * pow(1,128)

    def test_env_none_miss_is_black(self):
        got = self.trace_one(self.cfg(), [[0, 0, -1000, 1]], (0, 0, 0), (0, 0, 1))
        assert got == [0.0, 0.0, 0.0]

    def test_nonemissive_bounce_energy(self):
        """Hitting a diffuse sphere (index 1 of 2) with env none: energy is
        bounded by albedo * emissive/env reachable — here nothing emissive
        is reachable, so radiance can only come from RR-surviving paths that
        hit the emissive sphere 0."""
        cfg = self.cfg(env_mode="none")
        rows = [[0, 0, 50, 4],      # emissive (index 0), behind the camera
                [0, 0, -10, 2]]     # diffuse target
        got = self.trace_one(cfg, rows, (0, 0, 0), (0, 0, -1))
        assert all(v >= 0 for v in got)

    def test_batch_all_miss_black_without_env(self):
        """A batch of rays that all miss with env=none is exactly black."""
        cfg = self.cfg(env_mode="none")
        scene = make_sphere_scene([[0, 0, -10, 3]])
        isect = sphere_intersector(scene)
        shape = (64,)
        sampler = sampler_for(shape, seed=1, max_bounces=2)
        z = jnp.zeros(shape, jnp.float32)
        d = jnp.full(shape, 1.0, jnp.float32)  # away from the scene
        r, g, b = trace_path(cfg, isect, sampler, z, z, z, z, z, d)
        assert float(jnp.abs(r).max()) == 0.0
        assert float(jnp.abs(g).max()) == 0.0

    def test_emissive_every_config(self):
        """emissive_every=1 makes everything a light."""
        cfg = self.cfg(emissive_every=1)
        r = 3.0
        got = self.trace_one(cfg, [[0, 0, -10, 1], [5, 5, -20, r]],
                             (5, 5, 0), (0, 0, -1))
        expect = 8192.0 / (4 * PI * r * r)
        np.testing.assert_allclose(got, [expect] * 3, rtol=1e-5)


class TestAOVs:
    def setup_method(self):
        self.scene = make_sphere_scene([[0, 0, -10, 2]])
        self.isect = sphere_intersector(self.scene)
        self.args = [jnp.float32(v) for v in (0, 0, 0, 0, 0, -1)]
        self.miss_args = [jnp.float32(v) for v in (0, 0, 0, 0, 1, 0)]

    def shade(self, aov, args):
        cfg = RenderConfig(aov=aov, env_mode="none").validate()
        sampler = sampler_for((), seed=2)
        return [float(v) for v in shade(cfg, self.isect, sampler, *args)]

    def test_normal(self):
        assert self.shade("normal", self.args) == pytest.approx([0, 0, 1], abs=1e-5)
        assert self.shade("normal", self.miss_args) == [0, 0, 0]

    def test_hit(self):
        assert self.shade("hit", self.args) == [1, 1, 1]
        assert self.shade("hit", self.miss_args) == [0, 0, 0]

    def test_ambient_occlusion(self):
        # Single sphere: hemisphere ray always escapes => white on hit.
        assert self.shade("ambient_occlusion", self.args) == [1, 1, 1]
        assert self.shade("ambient_occlusion", self.miss_args) == [0, 0, 0]

    def test_tex_coords_on_triangle(self):
        spheres = compute_spheres(1, 64.0, seed=3)
        tri = build_triangle_scene(spheres, 16, 8)
        isect = triangle_intersector(tri.soup())
        cfg = RenderConfig(aov="tex_coords", scene_kind="triangle").validate()
        cx = float(spheres.center_x[0]); cy = float(spheres.center_y[0])
        cz = float(spheres.center_z[0])
        args = [jnp.float32(v) for v in (cx, cy, cz + 50, 0, 0, -1)]
        sampler = sampler_for((), seed=2)
        tc = shade(cfg, isect, sampler, *args)
        assert 0.0 <= float(tc[0]) <= 1.0 and 0.0 <= float(tc[1]) <= 1.0
        # Miss is magenta (triangle_pathtracing.cs.glsl:355).
        miss = shade(cfg, isect, sampler,
                     *[jnp.float32(v) for v in (cx, cy, cz + 50, 0, 0, 1)])
        assert [float(v) for v in miss] == [1.0, 0.0, 1.0]
