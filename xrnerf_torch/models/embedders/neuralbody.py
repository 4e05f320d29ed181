"""NeuralBody SMPL embedder — port of
``xrnerf_tpu/models/embedders/neuralbody.py``: 6890 × 16 learned vertex
codes, scatter-mean voxelised into a dense ``[D, H, W, C]`` grid over the
person box, a 3D conv stack of 4 levels (two 3×3×3 convs each, the second
at stride 2 from level 1 on), and each level's volume sampled at the query
points with 8 corner gathers (trilinear, the JAX version's clamping); the
levels' features are concatenated.

Layout: the convs run on ``[1, C, D, H, W]`` (``Conv3d``), the volume is
``[D, H, W, C]`` in ``voxelize_codes`` and ``trilinear_sample``.
Padding: flax's ``padding="SAME"`` pads ``total = max((ceil(n / s) - 1) s
+ k - n, 0)`` per axis with ``total // 2`` before and the rest after
(XLA's rule), so a stride-2 conv over an even size pads 0 before and 1
after; ``Conv3d``'s symmetric ``padding=1`` would shift the output grid by
one voxel. The port pads explicitly with ``F.pad`` and convolves with
``padding=0`` wherever the two pads differ. cuDNN on the card (TF32 off as
``utils.device.configure_card`` sets it), in ``dtype`` (f32 by default):
the JAX embedder runs plain ``nn.Conv`` and reaches no Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...utils.dtype import Conv3d, resolve_dtype
from ..fields.nerf_mlp import flax_init_


def voxelize_codes(verts, codes, bmin, bmax, dims: Sequence[int]) -> torch.Tensor:
    """Scatter-mean vertex codes [V, C] at verts [V, 3] into a dense
    [D, H, W, C] grid over the box [bmin, bmax]."""
    rel = (verts - bmin) / torch.clamp(bmax - bmin, min=1e-6)
    idx = [torch.clamp(torch.floor(rel[:, a] * dims[a]).to(torch.int64), 0, dims[a] - 1) for a in range(3)]
    flat = idx[0] * (dims[1] * dims[2]) + idx[1] * dims[2] + idx[2]
    n = dims[0] * dims[1] * dims[2]
    summed = codes.new_zeros((n, codes.shape[-1])).index_add(0, flat, codes)
    count = codes.new_zeros((n, 1)).index_add_(0, flat, torch.ones_like(codes[:, :1]))
    return (summed / torch.clamp(count, min=1.0)).reshape(*dims, codes.shape[-1])


def trilinear_sample(vol: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    """Sample a [D, H, W, C] volume at rel coords [P, 3] in [0, 1]^3 -> [P, C]
    (``F.grid_sample(align_corners=True)``'s function, as 8 corner gathers)."""
    dims = vol.shape[:3]
    flat = vol.reshape(-1, vol.shape[-1])
    i0, i1, w = [], [], []
    for a in range(3):
        x = rel[:, a] * (dims[a] - 1)
        x0 = torch.floor(x)
        w.append((x - x0)[:, None])
        lo = torch.clamp(x0.to(torch.int64), 0, dims[a] - 1)
        i0.append(lo)
        i1.append(torch.clamp(lo + 1, 0, dims[a] - 1))
    sy, sx = dims[2], dims[1] * dims[2]

    def g(ix, iy, iz):
        return flat.index_select(0, ix * sx + iy * sy + iz)

    c000, c001 = g(i0[0], i0[1], i0[2]), g(i0[0], i0[1], i1[2])
    c010, c011 = g(i0[0], i1[1], i0[2]), g(i0[0], i1[1], i1[2])
    c100, c101 = g(i1[0], i0[1], i0[2]), g(i1[0], i0[1], i1[2])
    c110, c111 = g(i1[0], i1[1], i0[2]), g(i1[0], i1[1], i1[2])
    wx, wy, wz = w
    c00 = c000 * (1 - wz) + c001 * wz
    c01 = c010 * (1 - wz) + c011 * wz
    c10 = c100 * (1 - wz) + c101 * wz
    c11 = c110 * (1 - wz) + c111 * wz
    c0 = c00 * (1 - wy) + c01 * wy
    c1 = c10 * (1 - wy) + c11 * wy
    return c0 * (1 - wx) + c1 * wx


def same_pads(size: int, stride: int, k: int = 3) -> Tuple[int, int]:
    """(before, after) of flax / XLA ``padding="SAME"`` on one axis."""
    total = max((math.ceil(size / stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv3d_same(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (built with ``padding=0``; a ``utils.dtype.Conv3d`` computes
    in its ``dtype``) over [1, C, D, H, W] with flax's SAME pads."""
    pads = [same_pads(n, s, k) for n, s, k in zip(x.shape[2:], conv.stride, conv.kernel_size)]
    if all(lo == hi for lo, hi in pads):  # symmetric: the conv pads, no copy
        pad = [lo for lo, _ in pads]
        return conv(x, pad) if isinstance(conv, Conv3d) else F.conv3d(x, conv.weight, conv.bias, conv.stride, pad)
    (d0, d1), (h0, h1), (w0, w1) = pads
    return conv(F.pad(x, (w0, w1, h0, h1, d0, d1)))


class SmplEmbedder(nn.Module):
    """``dtype`` is flax's compute dtype of the codes and the convs (the JAX
    field ``xrnerf_tpu/models/embedders/neuralbody.py:84``: ``nn.Embed``
    ``:96`` and the ``SAME`` convs ``:101``): the scatter-mean sums codes and
    counts in ``dtype``, each level's volume is sampled in f32 (``:110``)."""

    def __init__(
        self,
        n_verts: int = 6890,
        code_dim: int = 16,
        grid_dims: Tuple[int, int, int] = (96, 96, 96),
        widths: Sequence[int] = (32, 32, 32, 32),  # per downsample level
        dtype=torch.float32,
    ):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.n_verts, self.grid_dims, self.widths = n_verts, tuple(grid_dims), tuple(widths)
        self.vertex_codes = nn.Embedding(n_verts, code_dim)
        cin = code_dim
        for lvl, width in enumerate(self.widths):
            setattr(self, f"conv_{lvl}a", Conv3d(cin, width, 3, stride=1, dtype=self.dtype))
            setattr(self, f"conv_{lvl}b", Conv3d(width, width, 3, stride=2 if lvl > 0 else 1, dtype=self.dtype))
            cin = width

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's ``Embed`` (normal, std 1/sqrt(16)) and ``Conv`` (truncated
        lecun-normal over 27 · in, zero bias) initialisations."""
        flax_init_(self, generator)

    def forward(self, verts, pts, bmin, bmax) -> torch.Tensor:
        """verts [V, 3] posed vertices (vertex ids 0..V-1), pts [P, 3] query
        points, bmin / bmax [3] -> features [P, sum(widths)]."""
        dt = self.dtype
        vol = voxelize_codes(verts, self.vertex_codes.weight.to(dt), bmin, bmax, self.grid_dims)
        rel = torch.clamp((pts - bmin) / torch.clamp(bmax - bmin, min=1e-6), 0.0, 1.0)
        feats = []
        x = vol.permute(3, 0, 1, 2)[None]  # [1, C, D, H, W]
        for lvl in range(len(self.widths)):
            x = F.relu(conv3d_same(getattr(self, f"conv_{lvl}a"), x))
            x = F.relu(conv3d_same(getattr(self, f"conv_{lvl}b"), x))
            feats.append(trilinear_sample(x[0].permute(1, 2, 3, 0).float(), rel))
        return torch.cat(feats, dim=-1)
