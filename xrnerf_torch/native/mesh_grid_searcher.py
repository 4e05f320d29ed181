"""The native uniform-grid mesh searcher with the reference's
``MeshGridSearcher`` API — a copy of
``xrnerf_tpu/native/mesh_grid_searcher.py`` without its fallback: the
library must build (``native.load_mesh_grid`` raises otherwise). numpy in,
numpy out, on the host.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from . import load_mesh_grid


def _c(arr, typ):
    return arr.ctypes.data_as(ctypes.POINTER(typ))


class NativeMeshSearcher:
    """Host-side mesh queries over a uniform triangle grid."""

    def __init__(self, verts=None, faces=None, resolution: int = 0):
        self._lib = load_mesh_grid()
        self._handle = None
        self.resolution = resolution
        if verts is not None:
            self.set_mesh(verts, faces)

    def set_mesh(self, verts, faces):
        verts = np.ascontiguousarray(verts, np.float32)
        faces = np.ascontiguousarray(faces, np.int32)
        self.verts, self.faces = verts, faces
        if self._handle is not None:
            self._lib.mg_destroy(self._handle)
        # cell size ~ vertex density (the reference's mesh_grid_searcher.py:24-33)
        res = self.resolution or int(np.clip(round(len(verts) ** (1.0 / 3.0)), 4, 64))
        self._res = res
        self._handle = self._lib.mg_create(_c(verts, ctypes.c_float), len(verts), _c(faces, ctypes.c_int),
                                           len(faces), res)

    def nearest_points(self, pts):
        """-> (closest point [n, 3], face index [n])."""
        pts = np.ascontiguousarray(pts, np.float32)
        n = len(pts)
        out_p = np.empty((n, 3), np.float32)
        out_i = np.empty(n, np.int32)
        out_d = np.empty(n, np.float32)
        self._lib.mg_nearest(self._handle, _c(pts, ctypes.c_float), n, _c(out_p, ctypes.c_float),
                             _c(out_i, ctypes.c_int), _c(out_d, ctypes.c_float))
        return out_p, out_i

    def inside_mesh(self, pts):
        """+1 inside / -1 outside."""
        pts = np.ascontiguousarray(pts, np.float32)
        out = np.empty(len(pts), np.float32)
        self._lib.mg_inside(self._handle, _c(pts, ctypes.c_float), len(pts), _c(out, ctypes.c_float))
        return out

    def intersects(self, origins, dirs, t_max: Optional[np.ndarray] = None):
        """Any-hit per ray for t in (1e-6, t_max) -> bool [n]."""
        origins = np.ascontiguousarray(origins, np.float32)
        dirs = np.ascontiguousarray(dirs, np.float32)
        n = len(origins)
        t_max = np.full(n, np.inf, np.float32) if t_max is None else t_max
        t_max = np.ascontiguousarray(np.broadcast_to(t_max, (n,)), np.float32)
        out = np.empty(n, np.uint8)
        self._lib.mg_intersect(self._handle, _c(origins, ctypes.c_float), _c(dirs, ctypes.c_float), n,
                               _c(t_max, ctypes.c_float), _c(out, ctypes.c_uint8))
        return out.astype(bool)

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self._lib.mg_destroy(self._handle)
            self._handle = None
