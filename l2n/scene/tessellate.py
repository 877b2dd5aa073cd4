"""Lat/long sphere tessellation and the indexed triangle scene.

Analog of `tesselateSphereInfo` / `tesselateSphere` and
`TriangleProgram`'s five GL buffers (l2n-renderer/src/main.cpp:601-654,
714-788): vertices, vertex attributes (normal + texcoords), indices,
per-mesh triangle counts and index offsets. The indexed representation is
kept as the user-facing scene; kernels consume a *flattened pre-gathered
triangle soup* in SoA form (`TriangleScene.soup`) so the hot loop does no
index chasing — the lane-array answer to the reference's bindless pointer
arithmetic (triangle_pathtracing.cs.glsl:111-154).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import jax.numpy as jnp

from l2n.scene.spheres import SphereScene


def tessellate_sphere_info(disc_lat: int, disc_long: int) -> tuple[int, int]:
    """(vertex_count, index_count) per sphere (src/main.cpp:601-605):
    (discLong+1)*(discLat+1) vertices, discLong*discLat*6 indices."""
    return (disc_long + 1) * (disc_lat + 1), disc_long * disc_lat * 6


def tessellate_sphere(
    center: np.ndarray, radius: float, disc_lat: int, disc_long: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Tessellate one sphere (src/main.cpp:607-654).

    Parameterization: theta in [-pi/2, pi/2] over `disc_long` bands, phi in
    [0, 2pi] over `disc_lat` slices; vertex normal n = (sin(i*dPhi)*cosTheta,
    sinTheta, cos(i*dPhi)*cosTheta); position = center + r*n; texcoords =
    (i/discLat, 1 - j/discLong). Two triangles per quad with the reference's
    winding (main.cpp:642-653).

    Returns (positions (V,3), normals (V,3), texcoords (V,2), indices (I,))
    as numpy arrays.
    """
    rcp_lat, rcp_long = 1.0 / disc_lat, 1.0 / disc_long
    d_phi, d_theta = 2.0 * np.pi * rcp_lat, np.pi * rcp_long

    j = np.arange(disc_long + 1, dtype=np.float32)
    i = np.arange(disc_lat + 1, dtype=np.float32)
    cos_theta = np.cos(-np.pi * 0.5 + j * d_theta, dtype=np.float32)
    sin_theta = np.sin(-np.pi * 0.5 + j * d_theta, dtype=np.float32)
    # Vertex order matches the reference loop nest: j outer, i inner.
    nx = np.sin(i[None, :] * d_phi, dtype=np.float32) * cos_theta[:, None]
    ny = np.broadcast_to(sin_theta[:, None], nx.shape)
    nz = np.cos(i[None, :] * d_phi, dtype=np.float32) * cos_theta[:, None]
    normals = np.stack([nx, ny, nz], axis=-1).reshape(-1, 3).astype(np.float32)
    positions = np.asarray(center, np.float32)[None, :] + np.float32(radius) * normals
    tex = np.stack(
        np.broadcast_arrays(i[None, :] * rcp_lat, 1.0 - j[:, None] * rcp_long),
        axis=-1,
    ).reshape(-1, 2).astype(np.float32)

    # Index pattern per quad (i, j): (i, i+1, i+discLat+2), (i, i+discLat+2,
    # i+discLat+1) offset by j*(discLat+1) (main.cpp:642-653).
    jj = np.arange(disc_long, dtype=np.int32)
    ii = np.arange(disc_lat, dtype=np.int32)
    offset = (jj[:, None] * (disc_lat + 1) + ii[None, :]).reshape(-1)  # (Q,)
    row = disc_lat + 1
    quads = np.stack(
        [offset, offset + 1, offset + row + 1, offset, offset + row + 1, offset + row],
        axis=1,
    )
    return positions, normals, tex, quads.reshape(-1).astype(np.int32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TriangleScene:
    """Indexed triangle scene, SoA per buffer (TriangleProgram's five GL
    buffers, src/main.cpp:723-727). V vertices, I indices, M meshes."""

    vertices: jnp.ndarray       # (V, 3) f32
    normals: jnp.ndarray        # (V, 3) f32
    tex_coords: jnp.ndarray     # (V, 2) f32
    indices: jnp.ndarray        # (I,)   i32 — 3 consecutive per triangle
    triangle_count: jnp.ndarray  # (M,)  i32 — per-mesh triangle counts
    index_offset: jnp.ndarray   # (M,)   i32 — per-mesh offset into `indices`

    @property
    def mesh_count(self) -> int:
        return self.triangle_count.shape[0]

    @property
    def total_triangles(self) -> int:
        return self.indices.shape[0] // 3

    def soup(self) -> dict[str, jnp.ndarray]:
        """Flatten to a pre-gathered SoA triangle soup for kernels.

        Precomputes the Möller-Trumbore edges e1 = v2-v1, e2 = v3-v1
        (triangle_pathtracing.cs.glsl:119-120) and gathers per-corner
        attributes, so the intersection loop touches only flat (T,) arrays.
        Keys: v1{x,y,z}, e1{x,y,z}, e2{x,y,z}, n{a,b,c}{x,y,z},
        t{a,b,c}{u,v}, mesh_id.
        """
        tri = self.indices.reshape(-1, 3)
        v1 = self.vertices[tri[:, 0]]
        v2 = self.vertices[tri[:, 1]]
        v3 = self.vertices[tri[:, 2]]
        e1, e2 = v2 - v1, v3 - v1
        na, nb, nc = (self.normals[tri[:, k]] for k in range(3))
        ta, tb, tc = (self.tex_coords[tri[:, k]] for k in range(3))
        # Per-triangle mesh id from per-mesh spans (host-side; consumers
        # lift the whole soup to the device in one place).
        counts = np.asarray(self.triangle_count)
        mesh_id = np.repeat(np.arange(counts.shape[0], dtype=np.int32), counts)
        out = {"mesh_id": mesh_id}
        for name, arr in (("v1", v1), ("e1", e1), ("e2", e2),
                          ("na", na), ("nb", nb), ("nc", nc)):
            for k, ax in enumerate("xyz"):
                out[f"{name}{ax}"] = arr[:, k]
        for name, arr in (("ta", ta), ("tb", tb), ("tc", tc)):
            for k, ax in enumerate("uv"):
                out[f"{name}{ax}"] = arr[:, k]
        return out


def mesh_bounds(scene: TriangleScene) -> np.ndarray:
    """(M, 4) f32 [cx, cy, cz, r^2]: an exact-conservative bounding sphere
    per mesh (center = the corners' AABB midpoint, radius = the farthest
    corner, widened by 1e-5 relative). Cone NEE samples these cones in the
    oracle and in the native renderer alike (ops/nee.py)."""
    soup = {k: np.asarray(v) for k, v in scene.soup().items()}
    bounds = np.zeros((scene.mesh_count, 4), np.float32)
    v1 = np.stack([soup[f"v1{a}"] for a in "xyz"], 1)
    v2 = v1 + np.stack([soup[f"e1{a}"] for a in "xyz"], 1)
    v3 = v1 + np.stack([soup[f"e2{a}"] for a in "xyz"], 1)
    for m in range(scene.mesh_count):
        sel = soup["mesh_id"] == m
        if not sel.any():
            continue
        pts = np.concatenate([v1[sel], v2[sel], v3[sel]], 0)
        center = 0.5 * (pts.min(0) + pts.max(0))
        r2 = float(((pts - center) ** 2).sum(1).max()) * (1.0 + 1e-5)
        bounds[m] = [*center, r2]
    return bounds


def build_triangle_scene(
    spheres: SphereScene, disc_lat: int = 16, disc_long: int = 8
) -> TriangleScene:
    """Tessellate every sphere of the scene into one shared buffer set
    (TriangleProgram ctor, src/main.cpp:729-768): per-mesh index offsets are
    mesh_index * index_count, vertex indices are globally offset."""
    v_count, i_count = tessellate_sphere_info(disc_lat, disc_long)
    centers = np.stack([np.asarray(spheres.center_x), np.asarray(spheres.center_y),
                        np.asarray(spheres.center_z)], axis=1)
    radii = np.sqrt(np.asarray(spheres.sqr_radius))
    n = centers.shape[0]

    positions = np.empty((n * v_count, 3), np.float32)
    normals = np.empty((n * v_count, 3), np.float32)
    tex = np.empty((n * v_count, 2), np.float32)
    indices = np.empty(n * i_count, np.int32)
    for m in range(n):
        p, nrm, t, idx = tessellate_sphere(centers[m], radii[m], disc_lat, disc_long)
        positions[m * v_count:(m + 1) * v_count] = p
        normals[m * v_count:(m + 1) * v_count] = nrm
        tex[m * v_count:(m + 1) * v_count] = t
        indices[m * i_count:(m + 1) * i_count] = idx + m * v_count

    # HOST numpy buffers (see SphereScene): packing/digesting stays on the
    # host; traced consumers lift once.
    return TriangleScene(
        vertices=positions,
        normals=normals,
        tex_coords=tex,
        indices=indices,
        triangle_count=np.full((n,), i_count // 3, np.int32),
        index_offset=np.arange(n, dtype=np.int32) * np.int32(i_count),
    )
