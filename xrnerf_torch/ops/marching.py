"""Iso-surface extraction and mesh smoothing in numpy — a copy of
``xrnerf_tpu/ops/marching.py`` (the port imports nothing of the JAX
package; the function is the same, so the same volume gives the same
vertices and faces).

Marching tetrahedra: each cube splits into 6 tetrahedra; each tetrahedron's
sign pattern yields 0, 1 or 2 triangles with vertices on linearly
interpolated edge crossings, all cubes processed as one [N_cubes, 6] batch
of tets. The triangle soup is welded into an indexed mesh. It replaces the
reference's scikit-image ``marching_cubes_lewiner`` and trimesh's
``filter_laplacian`` in GNR's reconstruction.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# 6-tetrahedra decomposition of the unit cube around the 0-7 body
# diagonal (corner k = (x=k&1, y=(k>>1)&1, z=(k>>2)&1); the cycle
# 1-3-2-6-4-5 walks cube edges, so every tet is valid)
_TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
        [0, 5, 1, 7],
    ],
    np.int64,
)

_CORNER_OFFSETS = np.array(
    [[(k & 1), (k >> 1) & 1, (k >> 2) & 1] for k in range(8)], np.int64
)

# for each of the 16 tet sign cases: list of (edge pairs) triangles.
# edges are (a,b) corner-index pairs within the tet (0..3).
_TET_TRIS = {
    0b0001: [[(0, 1), (0, 2), (0, 3)]],
    0b0010: [[(1, 0), (1, 3), (1, 2)]],
    0b0100: [[(2, 0), (2, 1), (2, 3)]],
    0b1000: [[(3, 0), (3, 2), (3, 1)]],
    0b0011: [[(0, 2), (0, 3), (1, 3)], [(0, 2), (1, 3), (1, 2)]],
    0b0101: [[(0, 1), (2, 3), (0, 3)], [(0, 1), (1, 2), (2, 3)]],
    0b1001: [[(0, 1), (0, 2), (3, 2)], [(0, 1), (3, 2), (3, 1)]],
    0b0110: [[(1, 0), (2, 0), (2, 3)], [(1, 0), (2, 3), (1, 3)]],
    0b1010: [[(1, 0), (3, 0), (3, 2)], [(1, 0), (3, 2), (1, 2)]],
    0b1100: [[(2, 0), (3, 0), (3, 1)], [(2, 0), (3, 1), (2, 1)]],
    0b1110: [[(0, 1), (0, 3), (0, 2)]],
    0b1101: [[(1, 0), (1, 2), (1, 3)]],
    0b1011: [[(2, 0), (2, 3), (2, 1)]],
    0b0111: [[(3, 0), (3, 1), (3, 2)]],
}


def marching_tetrahedra(
    volume: np.ndarray, level: float = 0.5
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the ``volume == level`` isosurface.

    volume: [X, Y, Z] scalar field. Returns (verts [V,3] in index
    coordinates, faces [T,3] int). Faces are oriented with outward
    normals for fields where inside > level.
    """
    X, Y, Z = volume.shape
    xi, yi, zi = np.meshgrid(
        np.arange(X - 1), np.arange(Y - 1), np.arange(Z - 1), indexing="ij"
    )
    base = np.stack([xi, yi, zi], -1).reshape(-1, 3)  # [N, 3]

    corners = base[:, None, :] + _CORNER_OFFSETS[None]  # [N, 8, 3]
    vals = volume[corners[..., 0], corners[..., 1], corners[..., 2]]  # [N, 8]

    # fast reject: only keep cubes the surface crosses
    crossing = (vals.max(1) > level) & (vals.min(1) <= level)
    base, corners, vals = base[crossing], corners[crossing], vals[crossing]
    if base.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    tet_corners = corners[:, _TETS]  # [N, 6, 4, 3]
    tet_vals = vals[:, _TETS]  # [N, 6, 4]
    inside = tet_vals > level  # [N, 6, 4]
    case = (
        inside[..., 0] * 1
        + inside[..., 1] * 2
        + inside[..., 2] * 4
        + inside[..., 3] * 8
    )  # [N, 6]

    tris = []
    for c, tri_list in _TET_TRIS.items():
        sel = np.nonzero(case == c)
        if sel[0].size == 0:
            continue
        tc = tet_corners[sel]  # [M, 4, 3]
        tv = tet_vals[sel]  # [M, 4]
        for tri in tri_list:
            pts = []
            for a, b in tri:
                va, vb = tv[:, a], tv[:, b]
                t = (level - va) / np.where(
                    np.abs(vb - va) > 1e-12, vb - va, 1e-12
                )
                t = np.clip(t, 0.0, 1.0)[:, None]
                pts.append(tc[:, a] * (1 - t) + tc[:, b] * t)
            tris.append(np.stack(pts, 1))  # [M, 3, 3]
    if not tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    soup = np.concatenate(tris, 0).astype(np.float32)  # [T, 3, 3]

    # weld duplicate vertices (quantized keys)
    flat = soup.reshape(-1, 3)
    keys = np.round(flat * 1e5).astype(np.int64)
    _, idx, inv = np.unique(
        keys.view([("x", np.int64), ("y", np.int64), ("z", np.int64)]),
        return_index=True,
        return_inverse=True,
    )
    verts = flat[idx]
    faces = inv.reshape(-1, 3)
    # drop degenerate faces from clipped interpolations
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts, faces[good]


def laplacian_smooth(
    verts: np.ndarray, faces: np.ndarray, iterations: int = 3, lam: float = 0.5
) -> np.ndarray:
    """Umbrella-operator Laplacian smoothing (trimesh filter_laplacian
    semantics, without the volume correction)."""
    v = verts.copy()
    n = len(v)
    # neighbor adjacency via edge lists
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.concatenate([e, e[:, ::-1]])
    for _ in range(iterations):
        acc = np.zeros_like(v)
        cnt = np.zeros((n, 1), v.dtype)
        np.add.at(acc, e[:, 0], v[e[:, 1]])
        np.add.at(cnt, e[:, 0], 1.0)
        mean = acc / np.maximum(cnt, 1.0)
        v = v + lam * (mean - v)
    return v


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    fn = np.cross(
        verts[faces[:, 1]] - verts[faces[:, 0]],
        verts[faces[:, 2]] - verts[faces[:, 0]],
    )
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    norm = np.linalg.norm(vn, axis=-1, keepdims=True)
    return vn / np.maximum(norm, 1e-12)
