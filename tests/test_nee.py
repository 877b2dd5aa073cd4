"""Next event estimation tests (reference TODO.md wishlist item).

Validation against an analytically solvable configuration: a spherical
light of radius r at distance d directly above a Lambertian surface point
with its normal toward the light gives outgoing radiance
  L = albedo * Le * sin^2(alpha),  sin(alpha) = r/d
(exact for the fully visible spherical cap under cosine weighting).
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest

from l2n.config import RenderConfig
from l2n.maths.sampling import procedural_color
from l2n.ops.nee import make_sphere_light_sampler
from l2n.ops.pathtrace import trace_path
from l2n.ops.scenes import sphere_intersector
from l2n.rng.sampler import ThreefrySampler, max_pairs_per_sample
from l2n.scene.spheres import SphereScene


def make_scene():
    # Light (index 0, emissive): r=2 at z=10. Ground: big sphere below whose
    # top surface sits at z=-1 with normal +z.
    data = np.array([[0, 0, 10, 2.0], [0, 0, -100, 99.0]], np.float32)
    return SphereScene(center_x=jnp.asarray(data[:, 0]),
                       center_y=jnp.asarray(data[:, 1]),
                       center_z=jnp.asarray(data[:, 2]),
                       sqr_radius=jnp.asarray(data[:, 3] ** 2))


def estimate(nee: bool, bounces: int, n: int = 200_000, seed: int = 0,
             mis: bool = False, scene=None):
    scene = make_scene() if scene is None else scene
    isect = sphere_intersector(scene)
    cx, cy, cz, r2 = (scene.center_x, scene.center_y, scene.center_z,
                      scene.sqr_radius)
    ls = make_sphere_light_sampler(scene.count, 16,
                                   lambda i: (cx[i], cy[i], cz[i], r2[i]))
    cfg = RenderConfig(width=8, height=8, env_mode="none",
                       max_bounces=bounces, nee=nee, mis=mis).validate()
    pix = jnp.arange(n, dtype=jnp.uint32)
    z = jnp.zeros(n, jnp.float32)
    sampler = ThreefrySampler(seed, 0, pix, jnp.zeros(n, jnp.uint32),
                              max_pairs_per_sample(bounces, nee))
    r, g, b = trace_path(cfg, isect, sampler, z, z,
                         jnp.full(n, 3.0, jnp.float32), z, z,
                         jnp.full(n, -1.0, jnp.float32),
                         light_sampler=ls if nee else None)
    return np.asarray(r)


def estimate_triangle(nee: bool, bounces: int, n: int = 100_000,
                      seed: int = 0, mis: bool = False, spheres=None,
                      tess=(12, 6), origin_z: float = 3.0):
    """Same shooting-gallery setup over TESSELLATED meshes (the light is
    mesh 0, emissive by index; Le = scale/(4 pi * 1), glsl:268)."""
    from l2n.render.step import make_intersector
    from l2n.scene.tessellate import build_triangle_scene

    spheres = make_scene() if spheres is None else spheres
    tri = build_triangle_scene(spheres, *tess)
    cfg = RenderConfig(width=8, height=8, env_mode="none",
                       max_bounces=bounces, nee=nee, mis=mis,
                       scene_kind="triangle").validate()
    isect, _, ls, _ = make_intersector(cfg, tri)
    pix = jnp.arange(n, dtype=jnp.uint32)
    z = jnp.zeros(n, jnp.float32)
    sampler = ThreefrySampler(seed, 0, pix, jnp.zeros(n, jnp.uint32),
                              max_pairs_per_sample(bounces, nee))
    r, g, b = trace_path(cfg, isect, sampler, z, z,
                         jnp.full(n, float(origin_z), jnp.float32), z, z,
                         jnp.full(n, -1.0, jnp.float32),
                         light_sampler=ls if nee else None)
    return np.asarray(r)


def analytic_direct():
    le = 8192.0 / (4 * math.pi * 4.0)
    kd = float(procedural_color(jnp.int32(1))[0])
    return kd * le * (4.0 / 121.0)  # sin^2(alpha) = (r/d)^2


class TestNEE:
    def test_matches_analytic_direct(self):
        got = estimate(nee=True, bounces=1).mean()
        assert got == pytest.approx(analytic_direct(), rel=0.02)

    def test_agrees_with_bsdf_estimator(self):
        """Both estimators are unbiased for direct light; at depth high
        enough for BSDF sampling to see the light, means agree."""
        a = estimate(nee=False, bounces=6, n=400_000).mean()
        b = estimate(nee=True, bounces=1, n=100_000).mean()
        assert b == pytest.approx(a, rel=0.1)

    def test_variance_reduction(self):
        """The point of NEE: per-sample variance collapses (the light
        subtends ~3% of the hemisphere, so BSDF sampling mostly misses)."""
        a = estimate(nee=False, bounces=6, n=100_000)
        b = estimate(nee=True, bounces=1, n=100_000)
        assert b.std() < 0.25 * a.std()

    def test_emission_not_double_counted(self):
        """Indirect BSDF emission hits are suppressed under NEE: deepening
        the path must not inflate direct lighting."""
        shallow = estimate(nee=True, bounces=1, n=100_000).mean()
        deep = estimate(nee=True, bounces=4, n=100_000).mean()
        # Deep adds only interreflection (small here), never double emission.
        assert deep == pytest.approx(shallow, rel=0.1)
        assert deep >= shallow * 0.95

    def test_kernel_parity_with_nee(self):
        """Pallas kernel with NEE vs the oracle (interpret mode, CPU)."""
        from l2n.camera import Camera
        from l2n.render.program import SphereProgram
        from l2n.render.state import init_frame_state
        cfg = RenderConfig(width=128, height=64, tile_width=128,
                           tile_height=32, sphere_count=32, tiles_per_step=2,
                           nee=True, env_mode="none").validate()
        states = {}
        for backend in ("xla", "pallas"):
            prog = SphereProgram(cfg, backend=backend, interpret=True)
            st = init_frame_state(cfg)
            cam = Camera.from_config(cfg).packed()
            for _ in range(2):
                st = prog.step(st, cam)
            states[backend] = np.asarray(st.accum)
        d = np.abs(states["xla"] - states["pallas"])
        # Shadow-ray visibility flips at sphere silhouettes add a little
        # more fp-boundary noise than the emission-only path.
        assert np.sqrt((d ** 2).mean()) < 5e-3
        assert (d > 1e-3).mean() < 2e-3

    def test_config_validation(self):
        RenderConfig(nee=True, scene_kind="triangle").validate()  # r2: ok now
        with pytest.raises(ValueError):
            RenderConfig(nee=True, rng="tinymt").validate()
        with pytest.raises(ValueError):
            RenderConfig(mis=True).validate()  # mis requires nee


class TestTriangleNEE:
    """Cone (solid-angle) NEE over emissive mesh bounds — r1 VERDICT next
    item 5 (triangle-scene NEE + emissive meshes)."""

    def test_agrees_with_bsdf_estimator(self):
        a = estimate_triangle(nee=False, bounces=6, n=400_000).mean()
        b = estimate_triangle(nee=True, bounces=1, n=100_000).mean()
        assert b == pytest.approx(a, rel=0.15)

    def test_variance_reduction(self):
        a = estimate_triangle(nee=False, bounces=6, n=50_000)
        b = estimate_triangle(nee=True, bounces=1, n=50_000)
        assert b.std() < 0.3 * a.std()

class TestMIS:
    """Balance-heuristic MIS between NEE and BSDF sampling — r1 VERDICT
    next item 5 ('MIS on top of the existing NEE')."""

    def test_sphere_mis_matches_plain_nee(self):
        a = estimate(nee=True, bounces=2, n=200_000).mean()
        b = estimate(nee=True, bounces=2, n=200_000, mis=True).mean()
        assert b == pytest.approx(a, rel=0.05)

    def test_triangle_mis_matches_plain_nee(self):
        a = estimate_triangle(nee=True, bounces=2, n=100_000).mean()
        b = estimate_triangle(nee=True, bounces=2, n=100_000, mis=True).mean()
        assert b == pytest.approx(a, rel=0.1)

    def test_big_light_variance(self):
        """The MIS motivation: for a LARGE light, BSDF sampling is the
        better strategy and plain NEE's cos_L/d^2 term blows up near the
        light; MIS must not be (much) worse than either alone."""
        big = SphereScene(
            center_x=jnp.asarray([0.0, 0.0]),
            center_y=jnp.asarray([0.0, 0.0]),
            center_z=jnp.asarray([8.0, -100.0]),
            sqr_radius=jnp.asarray([36.0, 99.0 ** 2]))
        nee_only = estimate(nee=True, bounces=2, n=100_000, scene=big)
        with_mis = estimate(nee=True, bounces=2, n=100_000, mis=True,
                            scene=big)
        assert with_mis.mean() == pytest.approx(nee_only.mean(), rel=0.05)
        assert with_mis.std() <= nee_only.std() * 1.5

    def test_mis_kernel_parity(self):
        from l2n.camera import Camera
        from l2n.render.program import SphereProgram
        from l2n.render.state import init_frame_state
        cfg = RenderConfig(width=128, height=64, tile_width=128,
                           tile_height=32, sphere_count=32, tiles_per_step=2,
                           nee=True, mis=True, env_mode="none").validate()
        states = {}
        for backend in ("xla", "pallas"):
            prog = SphereProgram(cfg, backend=backend, interpret=True)
            st = init_frame_state(cfg)
            cam = Camera.from_config(cfg).packed()
            for _ in range(2):
                st = prog.step(st, cam)
            states[backend] = np.asarray(st.accum)
        d = np.abs(states["xla"] - states["pallas"])
        assert np.sqrt((d ** 2).mean()) < 5e-3
        assert (d > 1e-3).mean() < 2e-3


class TestAnalyticGates:
    """Closed-form oracles for the estimator families that previously had
    only estimator-vs-estimator agreement gates (r3 VERDICT item 8: the
    stochastic comparisons would miss a small shared bias)."""

    def test_cone_nee_matches_closed_form(self):
        """Cone NEE direct light vs the spherical-light closed form
        L = kd * Le * (r/d)^2 — the same oracle the AREA sampler is gated
        by, now for the triangle path's solid-angle strategy. Meshes emit
        with sqrRadius = 1 (Le = scale/(4 pi), glsl:268), so the r^2 in
        the emission does NOT cancel as it does for spheres. A fine
        tessellation keeps the inscribed-polyhedron flux deficit inside
        the statistical tolerance."""
        got = estimate_triangle(nee=True, bounces=1, n=200_000,
                                tess=(32, 16)).mean()
        le = 8192.0 / (4 * math.pi)  # mesh emission, sqrRadius = 1
        kd = float(procedural_color(jnp.int32(1))[0])
        want = kd * le * (4.0 / 121.0)  # sin^2(alpha) = (r/d)^2
        assert got == pytest.approx(want, rel=0.03)

    def test_cone_nee_fully_occluded_is_exactly_zero(self):
        """Known-visibility case: an occluder whose cone (from every floor
        point the camera rays reach) strictly contains the light's cone.
        Every shadow ray must hit the occluder first => the estimator is
        ZERO on every lane, not just small in the mean."""
        spheres = SphereScene(
            center_x=jnp.asarray([0.0, 0.0, 0.0], jnp.float32),
            center_y=jnp.asarray([0.0, 0.0, 0.0], jnp.float32),
            center_z=jnp.asarray([10.0, -100.0, 5.0], jnp.float32),
            sqr_radius=jnp.asarray([4.0, 99.0 ** 2, 9.0], jnp.float32))
        # light r=2 at z=10; floor top at z=-1; occluder r=3 at z=5:
        # from (0,0,-1) the light cone has sin a = 2/11, the occluder's
        # sin b ~ 3/6 — strictly covering even after tessellation shrink.
        got = estimate_triangle(nee=True, bounces=1, n=50_000,
                                spheres=spheres, origin_z=0.0)
        assert np.all(got == 0.0)

    @pytest.mark.parametrize("mis", [False, True])
    def test_triangle_furnace(self, mis):
        """Furnace gate for the triangle NEE (+MIS) path: a convex diffuse
        ball (mesh 1, constant procedural albedo kd) inside a huge
        emissive enclosure (mesh 0) reflects EXACTLY kd * Le per camera
        ray, independent of geometry — every direction above any surface
        point's horizon reaches the light. NEE sees the shading point
        inside the light's bound (solid angle 4 pi); with MIS the BSDF
        strategy's enclosure hits are balance-weighted. Any bias in either
        strategy's weights breaks the identity."""
        spheres = SphereScene(
            center_x=jnp.asarray([0.0, 0.0], jnp.float32),
            center_y=jnp.asarray([0.0, 0.0], jnp.float32),
            center_z=jnp.asarray([0.0, 0.0], jnp.float32),
            sqr_radius=jnp.asarray([50.0 ** 2, 2.0 ** 2], jnp.float32))
        got = estimate_triangle(nee=True, mis=mis, bounces=2, n=200_000,
                                spheres=spheres, origin_z=6.0,
                                tess=(16, 8)).mean()
        le = 8192.0 / (4 * math.pi)
        kd = float(procedural_color(jnp.int32(1))[0])
        assert got == pytest.approx(kd * le, rel=0.03), (got, kd * le)
