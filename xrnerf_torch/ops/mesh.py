"""Mesh queries: nearest point on a mesh, inside test, ray any-hit — port
of ``xrnerf_tpu/ops/mesh.py``.

Plain torch, brute force over every triangle, as the JAX code is: each
query is a dense [chunk, T] tile of point-triangle work followed by a
reduction over the triangles. Rows are independent, so the chunk size is
not part of the function; it bounds memory only.

The JAX code builds [chunk, T, 3] temporaries and lets XLA fuse them. Here
each coordinate is its own [chunk, T] tensor: the same formulas, in the
same order, evaluated one component at a time, so a card chunk holds a few
dozen [chunk, T] f32 tiles and no [chunk, T, 3] one, and the closest point
is recomputed for the winning face only. ``argmin`` keeps the first
minimum, as ``jnp.argmin`` does. Where two faces are within rounding of
each other (a point near an edge or a vertex) the face index may differ
from JAX's; the distance and the closest point then agree to rounding.

On the CPU a chunk is cut to ``CPU_TILE`` point-triangle pairs so that its
tiles stay in cache. Nothing here takes part in autograd: the queries run
under ``torch.no_grad()``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

CPU_TILE = 1 << 20  # point-triangle pairs per chunk on the CPU (4 MB a tile)


def _chunk_size(chunk: int, n_faces: int, device: torch.device) -> int:
    if device.type == "cpu":
        return max(1, min(chunk, CPU_TILE // max(n_faces, 1)))
    return chunk


def _dot(u: Sequence[torch.Tensor], v: Sequence[torch.Tensor]) -> torch.Tensor:
    return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]


def _sub(u, v):
    return [x - y for x, y in zip(u, v)]


def _safe(x: torch.Tensor) -> torch.Tensor:
    """``where(|x| > 1e-20, x, 1e-20)``: the JAX code's guarded denominator."""
    return torch.where(x.abs() > 1e-20, x, 1e-20)


def _closest(p, a, b, c):
    """Ericson RTCD 5.1.5, branchless, on lists of 3 broadcastable
    component tensors -> the closest point's 3 components."""
    ab, ac, ap = _sub(b, a), _sub(c, a), _sub(p, a)
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    bp = _sub(p, b)
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    cp = _sub(p, c)
    d5, d6 = _dot(ab, cp), _dot(ac, cp)
    del ap, bp, cp

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = _safe(va + vb + vc)
    v_face, w_face = vb / denom, vc / denom
    del denom

    v_ab = (d1 / _safe(d1 - d3)).clamp_(0.0, 1.0)
    w_ac = (d2 / _safe(d2 - d6)).clamp_(0.0, 1.0)
    t_bc = ((d4 - d3) / _safe((d4 - d3) + (d5 - d6))).clamp_(0.0, 1.0)

    # the regions in the JAX code's order of override: ab, ac, bc, a, b, c
    m_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    m_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    m_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
    m_a = (d1 <= 0) & (d2 <= 0)
    m_b = (d3 >= 0) & (d4 <= d3)
    m_c = (d6 >= 0) & (d5 <= d6)
    del va, vb, vc, d1, d2, d3, d4, d5, d6

    out = []
    for k in range(3):  # a + v * ab as one fma, as XLA contracts it
        o = torch.addcmul(torch.addcmul(a[k], v_face, ab[k]), w_face, ac[k])
        o = torch.where(m_ab, torch.addcmul(a[k], v_ab, ab[k]), o)
        o = torch.where(m_ac, torch.addcmul(a[k], w_ac, ac[k]), o)
        o = torch.where(m_bc, torch.addcmul(b[k], t_bc, c[k] - b[k]), o)
        o = torch.where(m_a, a[k], o)
        o = torch.where(m_b, b[k], o)
        out.append(torch.where(m_c, c[k], o))
    return out


def closest_point_triangle(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Closest point on triangle abc to p ([..., 3], broadcastable)."""
    return torch.stack(_closest(p.unbind(-1), a.unbind(-1), b.unbind(-1), c.unbind(-1)), -1)


def _corners(verts: torch.Tensor, faces: torch.Tensor):
    """Per-component rows [1, T] of the triangles' corners a, b, c."""
    faces = faces.long()
    return [[verts[faces[:, j], k][None] for k in range(3)] for j in range(3)]


@torch.no_grad()
def nearest_points(
    pts: torch.Tensor, verts: torch.Tensor, faces: torch.Tensor, chunk: int = 2048
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (closest point [P, 3], face index [P] int32, distance [P])."""
    a, b, c = _corners(verts, faces)
    faces = faces.long()
    step = _chunk_size(chunk, faces.shape[0], pts.device)
    best, idx, dist = [], [], []
    for s in range(0, pts.shape[0], step):
        p = pts[s:s + step]
        pc = [p[:, k:k + 1] for k in range(3)]
        cp = _closest(pc, a, b, c)
        d2 = (pc[0] - cp[0]).square_()
        d2 += (pc[1] - cp[1]).square_()
        d2 += (pc[2] - cp[2]).square_()
        del cp
        i = torch.argmin(d2, -1)
        dist.append(torch.sqrt(torch.gather(d2, 1, i[:, None])[:, 0]))
        del d2
        f = faces[i]
        corner = [[verts[f[:, j], k][:, None] for k in range(3)] for j in range(3)]
        best.append(torch.cat(_closest(pc, *corner), 1))
        idx.append(i.to(torch.int32))
    return torch.cat(best), torch.cat(idx), torch.cat(dist)


@torch.no_grad()
def winding_number(pts: torch.Tensor, verts: torch.Tensor, faces: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """Generalized winding number per point (~1 inside, ~0 outside): the sum
    over triangles of the signed solid angle (van Oosterom-Strackee) / 4pi."""
    a, b, c = _corners(verts, faces)
    step = _chunk_size(chunk, faces.shape[0], pts.device)
    out = []
    for s in range(0, pts.shape[0], step):
        p = pts[s:s + step]
        pc = [p[:, k:k + 1] for k in range(3)]
        ra, rb, rc = _sub(a, pc), _sub(b, pc), _sub(c, pc)
        la, lb, lc = (torch.sqrt(_dot(r, r)) for r in (ra, rb, rc))
        cross = [rb[1] * rc[2] - rb[2] * rc[1], rb[2] * rc[0] - rb[0] * rc[2], rb[0] * rc[1] - rb[1] * rc[0]]
        num = _dot(ra, cross)
        del cross
        den = la * lb * lc + _dot(ra, rb) * lc + _dot(rb, rc) * la + _dot(rc, ra) * lb
        out.append(torch.atan2(num, den).sum(-1) / (2.0 * math.pi))
    return torch.cat(out)


def inside_mesh(pts: torch.Tensor, verts: torch.Tensor, faces: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """+1 inside / -1 outside (winding number > 0.5), the reference's signs."""
    w = winding_number(pts, verts, faces, chunk=chunk)
    return torch.where(w > 0.5, 1.0, -1.0)


@torch.no_grad()
def ray_mesh_hit(
    origins: torch.Tensor, dirs: torch.Tensor, verts: torch.Tensor, faces: torch.Tensor,
    t_max: float = math.inf, chunk: int = 1024,
) -> torch.Tensor:
    """Any-hit ray-mesh test for t in (1e-6, t_max) -> bool [R] (Moeller-Trumbore)."""
    a, b, c = _corners(verts, faces)
    e1, e2 = _sub(b, a), _sub(c, a)
    step = _chunk_size(chunk, len(faces), origins.device)
    out = []
    for s in range(0, origins.shape[0], step):
        o = [origins[s:s + step, k:k + 1] for k in range(3)]
        d = [dirs[s:s + step, k:k + 1] for k in range(3)]
        pvec = [d[1] * e2[2] - d[2] * e2[1], d[2] * e2[0] - d[0] * e2[2], d[0] * e2[1] - d[1] * e2[0]]
        det = _dot(e1, pvec)
        ok = det.abs() > 1e-12
        inv = 1.0 / torch.where(ok, det, 1e-12)
        tvec = _sub(o, a)
        u = _dot(tvec, pvec) * inv
        qvec = [tvec[1] * e1[2] - tvec[2] * e1[1], tvec[2] * e1[0] - tvec[0] * e1[2],
                tvec[0] * e1[1] - tvec[1] * e1[0]]
        v = _dot(d, qvec) * inv
        t = _dot(e2, qvec) * inv
        hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-6) & (t < t_max)
        out.append(hit.any(-1))
    return torch.cat(out)


class MeshSearcher:
    """Stateful wrapper with the reference's ``MeshGridSearcher`` API."""

    def __init__(self, verts=None, faces=None, device="cpu"):
        self.device = torch.device(device)
        self.verts = self.faces = None
        if verts is not None:
            self.set_mesh(verts, faces)

    def set_mesh(self, verts, faces):
        self.verts = torch.as_tensor(verts, dtype=torch.float32, device=self.device)
        self.faces = torch.as_tensor(faces, dtype=torch.int64, device=self.device)

    def _pts(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def nearest_points(self, pts):
        best, idx, _ = nearest_points(self._pts(pts), self.verts, self.faces)
        return best, idx

    def inside_mesh(self, pts):
        return inside_mesh(self._pts(pts), self.verts, self.faces)

    def intersects(self, origins, dirs, t_max=math.inf):
        return ray_mesh_hit(self._pts(origins), self._pts(dirs), self.verts, self.faces, t_max)
