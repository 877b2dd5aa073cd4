"""Wavefront OBJ loading into a TriangleScene.

An item from the reference's own wishlist (l2n-renderer/TODO.md: "Obj
loading with tinyobjloader") that it never implemented. Pure-Python parser:
v / vn / vt / f records, polygon fan triangulation, negative indices, o/g
groups -> meshes. Missing normals fall back to face normals; missing
texcoords to zeros.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import jax.numpy as jnp

from l2n.scene.tessellate import TriangleScene


def _resolve(idx: int, count: int) -> int:
    # OBJ indices are 1-based; negative indices count from the end.
    return idx - 1 if idx > 0 else count + idx


def load_obj(source: str | Path) -> TriangleScene:
    """Parse OBJ text (a path or the file contents) into a TriangleScene."""
    text = source
    if isinstance(source, Path) or (isinstance(source, str)
                                    and "\n" not in source
                                    and Path(source).exists()):
        text = Path(source).read_text()

    positions: list[list[float]] = []
    normals: list[list[float]] = []
    texcoords: list[list[float]] = []
    # Per-mesh lists of triangles; each corner is (v, vt, vn) (-1 = absent).
    meshes: list[list[tuple]] = []
    current: list[tuple] = []

    def start_group():
        nonlocal current
        if current:
            meshes.append(current)
        current = []

    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "v":
            positions.append([float(x) for x in parts[1:4]])
        elif tag == "vn":
            normals.append([float(x) for x in parts[1:4]])
        elif tag == "vt":
            texcoords.append([float(x) for x in parts[1:3]])
        elif tag in ("o", "g"):
            start_group()
        elif tag == "f":
            corners = []
            for spec in parts[1:]:
                fields = spec.split("/")
                v = _resolve(int(fields[0]), len(positions))
                vt = (_resolve(int(fields[1]), len(texcoords))
                      if len(fields) > 1 and fields[1] else -1)
                vn = (_resolve(int(fields[2]), len(normals))
                      if len(fields) > 2 and fields[2] else -1)
                corners.append((v, vt, vn))
            for i in range(1, len(corners) - 1):  # fan triangulation
                current.append((corners[0], corners[i], corners[i + 1]))
    start_group()
    meshes = [m for m in meshes if m]
    if not meshes:
        raise ValueError("OBJ contains no faces")

    pos = np.asarray(positions, np.float32)
    nrm = np.asarray(normals, np.float32) if normals else np.zeros((0, 3),
                                                                   np.float32)
    tex = np.asarray(texcoords, np.float32) if texcoords else np.zeros(
        (0, 2), np.float32)

    # Expand to unique (v, vt, vn) corners per mesh, building the shared
    # buffers the TriangleScene holds (TriangleProgram's layout,
    # src/main.cpp:723-727).
    out_pos: list[np.ndarray] = []
    out_nrm: list[np.ndarray] = []
    out_tex: list[np.ndarray] = []
    indices: list[int] = []
    counts: list[int] = []
    offsets: list[int] = []
    corner_cache: dict[tuple, int] = {}

    def corner_index(corner, face_normal):
        key = corner
        if key in corner_cache:
            return corner_cache[key]
        v, vt, vn = corner
        out_pos.append(pos[v])
        out_nrm.append(nrm[vn] if vn >= 0 else face_normal)
        out_tex.append(tex[vt] if vt >= 0 else np.zeros(2, np.float32))
        corner_cache[key] = len(out_pos) - 1
        return corner_cache[key]

    for mesh in meshes:
        offsets.append(len(indices))
        counts.append(len(mesh))
        for (a, b, c) in mesh:
            e1 = pos[b[0]] - pos[a[0]]
            e2 = pos[c[0]] - pos[a[0]]
            fn = np.cross(e1, e2)
            ln = np.linalg.norm(fn)
            fn = fn / ln if ln > 0 else np.array([0, 0, 1], np.float32)
            for corner in (a, b, c):
                indices.append(corner_index(corner, fn.astype(np.float32)))

    # HOST numpy buffers (see SphereScene): the kernel packers digest the
    # scene on the host; traced consumers lift once.
    return TriangleScene(
        vertices=np.stack(out_pos).astype(np.float32),
        normals=np.stack(out_nrm).astype(np.float32),
        tex_coords=np.stack(out_tex).astype(np.float32),
        indices=np.asarray(indices, np.int32),
        triangle_count=np.asarray(counts, np.int32),
        index_offset=np.asarray(offsets, np.int32),
    )
