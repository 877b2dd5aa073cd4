"""Golden tests for the math layer (SURVEY.md §7 stage 1)."""

import numpy as np
import jax.numpy as jnp
import pytest

from l2n.maths import linalg, sampling


class TestLinalg:
    def test_look_at_identity(self):
        # Camera at origin looking down -z with +y up => identity view.
        m = linalg.look_at(np.zeros(3), np.array([0, 0, -1.0]), np.array([0, 1.0, 0]))
        np.testing.assert_allclose(m, np.eye(4), atol=1e-6)

    def test_look_at_translation(self):
        eye = np.array([1.0, 2.0, 3.0], np.float32)
        m = linalg.look_at(eye, eye + np.array([0, 0, -1.0], np.float32),
                           np.array([0, 1.0, 0], np.float32))
        p = m @ np.array([1.0, 2.0, 3.0, 1.0], np.float32)
        np.testing.assert_allclose(p[:3], 0.0, atol=1e-6)

    def test_look_at_inverse_roundtrip(self):
        eye = np.array([10.0, -5.0, 2.0], np.float32)
        m = linalg.look_at(eye, np.zeros(3, np.float32), np.array([0, 1.0, 0]))
        inv = linalg.inverse(m)
        np.testing.assert_allclose(linalg.camera_position(inv), eye, atol=1e-4)

    def test_perspective_matches_fovy_trick(self):
        """The GPU kernel's NDC scaling by (ratio*tanHalfFovy, tanHalfFovy,
        -1, 1) must equal applying the inverse perspective matrix (the
        reference asserts this equivalence in a comment, glsl:380)."""
        fovy, ratio = np.radians(45.0), 1280 / 720
        proj = linalg.perspective(fovy, ratio, 0.01, 100.0)
        rcp_proj = linalg.inverse(proj)
        ndc = np.array([0.3, -0.7, 1.0, 1.0], np.float32)
        via_matrix = rcp_proj @ ndc
        via_matrix = via_matrix / via_matrix[3]
        t = np.tan(0.5 * fovy)
        via_trick = np.array([ndc[0] * ratio * t, ndc[1] * t, -1.0, 1.0])
        # Directions from the camera origin must agree (the trick lands on
        # the z=-1 plane; the matrix on the far plane).
        np.testing.assert_allclose(
            via_trick[:3] / np.linalg.norm(via_trick[:3]),
            via_matrix[:3] / np.linalg.norm(via_matrix[:3]), atol=1e-5)

    def test_rotate_orthonormal(self):
        m = linalg.rotate(np.eye(4, dtype=np.float32), 0.7, np.array([0, 1.0, 0]))
        r = m[:3, :3]
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-6)
        # Rotation about +y by a: +x axis -> (cos a, 0, -sin a).
        np.testing.assert_allclose(
            r @ np.array([1.0, 0, 0]), [np.cos(0.7), 0, -np.sin(0.7)], atol=1e-6)

    def test_camera_axes(self):
        rcp = np.eye(4, dtype=np.float32)
        front, left, up = linalg.camera_axes(rcp)
        np.testing.assert_allclose(front, [0, 0, -1])
        np.testing.assert_allclose(left, [-1, 0, 0])
        np.testing.assert_allclose(up, [0, 1, 0])


class TestSampling:
    def test_frame_z_orthonormal(self, rng):
        z = rng.normal(size=(100, 3)).astype(np.float32)
        z /= np.linalg.norm(z, axis=1, keepdims=True)
        zx, zy, zz = (jnp.asarray(z[:, i]) for i in range(3))
        (tx, ty, tz), (bx, by, bz) = sampling.frame_z(zx, zy, zz)
        t = np.stack([tx, ty, tz], 1)
        b = np.stack([bx, by, bz], 1)
        np.testing.assert_allclose(np.linalg.norm(t, axis=1), 1.0, atol=1e-5)
        np.testing.assert_allclose((t * z).sum(1), 0.0, atol=1e-5)
        np.testing.assert_allclose((t * b).sum(1), 0.0, atol=1e-5)
        np.testing.assert_allclose((b * z).sum(1), 0.0, atol=1e-5)
        # Right-handed: cross(z, t) == b (glsl:115).
        np.testing.assert_allclose(np.cross(z, t), b, atol=1e-5)

    def test_frame_z_branch(self):
        """Tangent formula branches on |z.y| > |z.x| (glsl:107-114)."""
        (tx, ty, tz), _ = sampling.frame_z(
            jnp.float32(0.1), jnp.float32(0.9), jnp.float32(0.42))
        ln = np.hypot(0.1, 0.9)
        np.testing.assert_allclose([tx, ty, tz], [0.9 / ln, -0.1 / ln, 0.0],
                                   rtol=1e-5)
        (tx, ty, tz), _ = sampling.frame_z(
            jnp.float32(0.9), jnp.float32(0.1), jnp.float32(0.42))
        ln = np.hypot(0.9, 0.42)
        np.testing.assert_allclose([tx, ty, tz], [0.42 / ln, 0.0, -0.9 / ln],
                                   rtol=1e-5)

    def test_fast_sqrt_ulp_bound(self, rng):
        """cfg.fast_math's x*rsqrt(x) form stays within ~2 ulp of sqrt
        across 12 decades (the sweep discriminants span t^2 scales), and
        its x == 0 NaN poison is the documented behavior."""
        x = np.float32(10.0) ** rng.uniform(-6, 6, size=4096).astype(np.float32)
        exact = np.sqrt(x)
        fast = np.asarray(sampling.fast_sqrt(jnp.asarray(x)))
        ulp = np.abs(fast.view(np.int32) - exact.view(np.int32))
        assert ulp.max() <= 2
        assert np.isnan(np.asarray(sampling.fast_sqrt(jnp.float32(0.0))))

    def test_normalize3_fast_matches_exact(self, rng):
        v = rng.normal(size=(4096, 3)).astype(np.float32) * np.float32(3.0)
        args = tuple(jnp.asarray(v[:, i]) for i in range(3))
        v64 = v.astype(np.float64)
        ex = v64 / np.linalg.norm(v64, axis=1, keepdims=True)
        fa = np.stack(sampling.normalize3(*args), 1)
        np.testing.assert_allclose(np.linalg.norm(fa, axis=1), 1.0, atol=2e-6)
        np.testing.assert_allclose(fa, ex, atol=2e-6)

    def test_frame_z_fast_matches_exact(self, rng):
        z = rng.normal(size=(4096, 3)).astype(np.float32)
        z /= np.linalg.norm(z, axis=1, keepdims=True)
        args = tuple(jnp.asarray(z[:, i]) for i in range(3))
        (fx, fy, fz), (gx, gy, gz) = sampling.frame_z(*args)
        # Exact float64 frame: t = (z.y, -z.x, 0)/|z.xy| where |z.y| > |z.x|,
        # else (z.z, 0, -z.x)/|z.xz| (frameZ); b = z x t.
        z64 = z.astype(np.float64)
        use_y = np.abs(z64[:, 1]) > np.abs(z64[:, 0])
        ta = np.stack([z64[:, 1], -z64[:, 0], 0 * z64[:, 0]], 1)
        tb = np.stack([z64[:, 2], 0 * z64[:, 0], -z64[:, 0]], 1)
        t64 = np.where(use_y[:, None], ta, tb)
        t64 /= np.linalg.norm(t64, axis=1, keepdims=True)
        np.testing.assert_allclose(np.stack([fx, fy, fz], 1), t64,
                                   atol=2e-6)
        np.testing.assert_allclose(np.stack([gx, gy, gz], 1),
                                   np.cross(z64, t64), atol=2e-5)
        # Orthonormality survives the rsqrt form.
        t = np.stack([fx, fy, fz], 1)
        b = np.stack([gx, gy, gz], 1)
        np.testing.assert_allclose(np.linalg.norm(t, axis=1), 1.0, atol=2e-6)
        np.testing.assert_allclose((t * z).sum(1), 0.0, atol=2e-6)
        np.testing.assert_allclose(np.cross(z, t), b, atol=2e-5)

    def test_cosine_hemisphere(self, rng):
        u = rng.random((2, 5000), dtype=np.float32)
        (x, y, z), jac = sampling.cosine_sample_hemisphere(
            jnp.asarray(u[0]), jnp.asarray(u[1]))
        v = np.stack([x, y, z], 1)
        np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, atol=1e-4)
        assert (np.asarray(z) >= 0).all()
        # Cosine-weighted: E[cos theta] = 2/3.
        assert abs(np.asarray(z).mean() - 2 / 3) < 0.02
        np.testing.assert_allclose(np.asarray(jac) * np.asarray(z),
                                   sampling.PI, rtol=1e-4)

    def test_uniform_hemisphere(self, rng):
        u = rng.random((2, 2000), dtype=np.float32)
        (x, y, z), jac = sampling.uniform_sample_hemisphere(
            jnp.asarray(u[0]), jnp.asarray(u[1]))
        # glsl:119-125: z = u1 (uniform in [0,1]).
        np.testing.assert_allclose(np.asarray(z), u[0], atol=1e-6)
        np.testing.assert_allclose(np.asarray(jac), 2 * sampling.PI)

    def test_uniform_disk(self, rng):
        u = rng.random((2, 2000), dtype=np.float32)
        x, y, _ = sampling.uniform_sample_disk(
            jnp.float32(2.0), jnp.asarray(u[0]), jnp.asarray(u[1]))
        r = np.hypot(np.asarray(x), np.asarray(y))
        assert (r <= 2.0 + 1e-5).all()
        # Uniform on disk of radius R: E[r] = 2R/3.
        assert abs(r.mean() - 4 / 3) < 0.05

    def test_luminance(self):
        # Coefficients sum to ~1 (glsl:224-226).
        assert abs(float(sampling.luminance(
            jnp.float32(1), jnp.float32(1), jnp.float32(1))) - 1.0) < 1e-5

    def test_procedural_color_range_and_determinism(self):
        n = jnp.arange(128, dtype=jnp.int32)
        r, g, b = sampling.procedural_color(n)
        for c in (r, g, b):
            c = np.asarray(c)
            assert ((c >= 0) & (c < 1)).all()
        r2, _, _ = sampling.procedural_color(n)
        np.testing.assert_array_equal(np.asarray(r), np.asarray(r2))
        # Distinct objects get distinct colors (hash property, glsl:215-222);
        # f32 sin of large args quantizes per channel, so check jointly.
        rgb = np.stack([np.asarray(r), np.asarray(g), np.asarray(b)], 1)
        assert len(np.unique(rgb.round(6), axis=0)) > 120
