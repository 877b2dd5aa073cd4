"""Scene generation and tessellation tests (reference: src/main.cpp:601-669)."""

import numpy as np
import pytest

from l2n.scene import (
    SphereScene,
    build_triangle_scene,
    compute_spheres,
    tessellate_sphere,
    tessellate_sphere_info,
)


class TestSpheres:
    def test_distribution_bounds(self):
        s = compute_spheres(128, 1024.0, seed=0)
        for c in (s.center_x, s.center_y, s.center_z):
            c = np.asarray(c)
            assert (c >= -512.0).all() and (c <= 512.0).all()
        r = np.sqrt(np.asarray(s.sqr_radius))
        assert (r >= 0).all() and (r <= 0.05 * 1024.0).all()
        assert s.count == 128

    def test_deterministic_and_seedable(self):
        a = compute_spheres(16, 1024.0, seed=0)
        b = compute_spheres(16, 1024.0, seed=0)
        c = compute_spheres(16, 1024.0, seed=1)
        np.testing.assert_array_equal(np.asarray(a.center_x), np.asarray(b.center_x))
        assert not np.array_equal(np.asarray(a.center_x), np.asarray(c.center_x))

    def test_as_numpy_layout(self):
        s = compute_spheres(8, 100.0, seed=2)
        arr = s.as_numpy()
        assert arr.shape == (8, 4) and arr.dtype == np.float32
        np.testing.assert_array_equal(arr[:, 3], np.asarray(s.sqr_radius))


class TestTessellation:
    def test_info_counts(self):
        # Reference default 16x8: 153 vertices, 768 indices (SURVEY §2).
        v, i = tessellate_sphere_info(16, 8)
        assert v == 153 and i == 768

    def test_vertices_on_sphere(self):
        center = np.array([1.0, 2.0, 3.0], np.float32)
        pos, nrm, tex, idx = tessellate_sphere(center, 2.0, 16, 8)
        d = np.linalg.norm(pos - center, axis=1)
        np.testing.assert_allclose(d, 2.0, atol=1e-4)
        np.testing.assert_allclose(np.linalg.norm(nrm, axis=1), 1.0, atol=1e-5)
        # Normals point outward: position = center + r * normal.
        np.testing.assert_allclose(pos, center + 2.0 * nrm, atol=1e-4)
        assert tex.min() >= 0.0 and tex.max() <= 1.0
        assert idx.min() >= 0 and idx.max() < pos.shape[0]

    def test_poles(self):
        """First band is the south pole (theta=-pi/2 => n=(0,-1,0)), last the
        north pole (main.cpp:628-636)."""
        _, nrm, _, _ = tessellate_sphere(np.zeros(3), 1.0, 16, 8)
        np.testing.assert_allclose(nrm[:17], [[0, -1, 0]] * 17, atol=1e-6)
        np.testing.assert_allclose(nrm[-17:], [[0, 1, 0]] * 17, atol=1e-6)

    def test_triangle_winding_consistent(self):
        """All face normals of a tessellated sphere must point outward."""
        pos, _, _, idx = tessellate_sphere(np.zeros(3), 1.0, 16, 8)
        tri = idx.reshape(-1, 3)
        v1, v2, v3 = pos[tri[:, 0]], pos[tri[:, 1]], pos[tri[:, 2]]
        fn = np.cross(v2 - v1, v3 - v1)
        centroid = (v1 + v2 + v3) / 3
        dots = (fn * centroid).sum(1)
        area = np.linalg.norm(fn, axis=1)
        # Degenerate pole triangles aside, outward orientation everywhere.
        assert (dots[area > 1e-7] > 0).all()

    def test_build_triangle_scene(self):
        spheres = compute_spheres(4, 256.0, seed=0)
        ts = build_triangle_scene(spheres, 16, 8)
        assert ts.mesh_count == 4
        assert ts.total_triangles == 4 * 256
        np.testing.assert_array_equal(np.asarray(ts.triangle_count), [256] * 4)
        np.testing.assert_array_equal(np.asarray(ts.index_offset),
                                      [0, 768, 1536, 2304])
        soup = ts.soup()
        assert soup["v1x"].shape == (1024,)
        np.testing.assert_array_equal(
            np.asarray(soup["mesh_id"]), np.repeat(np.arange(4), 256))
        # Soup edges match indexed vertices.
        tri0 = np.asarray(ts.indices[:3])
        v = np.asarray(ts.vertices)
        np.testing.assert_allclose(
            np.asarray(soup["e1x"])[0], (v[tri0[1]] - v[tri0[0]])[0], atol=1e-6)


class TestMaterialsAndLights:
    """Declared-but-unused-in-shading parity surface (glsl:9-38,52-69)."""

    def test_structures(self):
        import numpy as np
        from l2n.scene import (DirectionalLights, PhongMaterials,
                                   PointLights, empty_lights)
        mats = PhongMaterials.from_arrays(
            np.ones((3, 4)), np.zeros((3, 3)), np.full(3, 32.0))
        assert mats.count == 3
        assert float(mats.shininess[0]) == 32.0
        pl = PointLights.from_arrays([[0, 1, 2]], [[5, 5, 5]])
        assert pl.count == 1 and float(pl.z[0]) == 2.0
        dl = DirectionalLights.from_arrays([[0, -1, 0]], [[1, 1, 1]])
        assert dl.count == 1
        m0, p0, d0 = empty_lights()
        assert m0.count == p0.count == d0.count == 0

    def test_programs_carry_buffers(self):
        from l2n.config import RenderConfig
        from l2n.render.program import SphereProgram
        cfg = RenderConfig(width=128, height=32, tile_width=128,
                           tile_height=32, sphere_count=4)
        prog = SphereProgram(cfg, backend="xla")
        assert prog.materials.count == 0  # reference default: empty buffers
        assert prog.point_lights.count == 0


class TestObjLoading:
    """OBJ import (reference TODO.md wishlist item, implemented here)."""

    CUBE = """
# unit cube, two groups
o front
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vn 0 0 -1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
f 1/1/1 2/2/1 3/3/1 4/4/1
o back
v 0 0 1
v 1 0 1
v 1 1 1
v 0 1 1
f -4 -3 -2 -1
"""

    def test_parse_groups_and_fans(self):
        from l2n.scene.obj import load_obj
        import numpy as np
        scene = load_obj(self.CUBE)
        assert scene.mesh_count == 2
        # Quads fan-triangulate into 2 triangles each.
        np.testing.assert_array_equal(np.asarray(scene.triangle_count), [2, 2])
        np.testing.assert_array_equal(np.asarray(scene.index_offset), [0, 6])
        # Normals: explicit for mesh 0, face normal fallback for mesh 1.
        n = np.asarray(scene.normals)
        tri0 = np.asarray(scene.indices[:3])
        np.testing.assert_allclose(n[tri0[0]], [0, 0, -1], atol=1e-6)

    def test_renders(self):
        import numpy as np
        import jax.numpy as jnp
        from l2n.scene.obj import load_obj
        from l2n.ops.scenes import triangle_intersector
        scene = load_obj(self.CUBE)
        isect = triangle_intersector(scene.soup())
        # Ray down +z through the front face center.
        h = isect(*(jnp.float32(v) for v in (0.5, 0.5, -1, 0, 0, 1)))
        assert float(h.t) > 0
        assert int(h.index) == 0

    def test_file_roundtrip(self, tmp_path):
        from l2n.scene.obj import load_obj
        p = tmp_path / "cube.obj"
        p.write_text(self.CUBE)
        scene = load_obj(p)
        assert scene.total_triangles == 4


class TestTorusField:
    """Procedural OBJ benchmark scene (scene/procgen.py)."""

    def test_deterministic_and_well_formed(self):
        import numpy as np
        from l2n.scene.obj import load_obj
        from l2n.scene.procgen import torus_field_obj

        text = torus_field_obj(n_tori=4, seg_u=8, seg_v=6)
        assert text == torus_field_obj(n_tori=4, seg_u=8, seg_v=6)
        scene = load_obj(text)
        assert scene.mesh_count == 4
        # Closed torus: 2 triangles per quad, seg_u*seg_v quads per torus.
        np.testing.assert_array_equal(
            np.asarray(scene.triangle_count), [2 * 8 * 6] * 4)
        # Supplied normals are unit length.
        n = np.asarray(scene.normals)
        np.testing.assert_allclose(
            np.linalg.norm(n, axis=-1), 1.0, atol=1e-4)

    def test_inside_world_volume(self):
        import numpy as np
        from l2n.scene.obj import load_obj
        from l2n.scene.procgen import torus_field_obj

        scene = load_obj(torus_field_obj(n_tori=8, world_size=1024.0))
        v = np.asarray(scene.vertices)
        # centers in +-512, max extent major+minor < 0.0725*1024 ~ 74.
        assert np.abs(v).max() < 512.0 + 80.0
