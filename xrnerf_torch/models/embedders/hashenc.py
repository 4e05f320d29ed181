"""Multiresolution hash encoding (Instant-NGP), vertex layout, forward —
port of ``xrnerf_tpu/models/embedders/hashenc.py``.

One stacked table parameter [L, T, F]; per level the 8 corners of the cell
around a point are looked up and trilinearly interpolated. Coarse levels
whose dense grid fits under T are indexed injectively, finer ones by NGP's
spatial hash (tcnn's tied-grid behaviour); the split is decided at
construction in Python integers (2048^3 overflows int32). Corner indices
are computed for all levels at once, the rows gathered per level from the
[T, F] slice, as the JAX package does.

The hash is computed in int64 and masked to ``T - 1``: T is a power of two,
so the low bits equal the JAX package's wrapped-int32 product followed by a
non-negative ``% T``.

Gradients come from autograd (the table's through ``index_select``); the
JAX package's scatter-free table gradient and its ``BrickHashEncoding`` are
not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

# NGP's spatial hash primes (pi1 = 1 for x).
_PRIMES = (1, 2654435761, 805459861)

# corner offsets of a cell, k fastest: [8, 3]
_CORNERS = tuple((i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1))


def per_level_scale(max_res: int, base_res: int, n_levels: int) -> float:
    """Growth factor b = exp2(log2(max_res / base_res) / (L - 1))."""
    return float(np.exp2(np.log2(max_res / base_res) / max(n_levels - 1, 1)))


def _level_resolutions(base_res: int, scale: float, n_levels: int) -> np.ndarray:
    return np.floor(base_res * scale ** np.arange(n_levels)).astype(np.int64)


def _corner_weights(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """t [..., 3] -> trilerp weights, the 8 corners (order = _CORNERS)
    stacked along ``dim`` of the [...] shape ([..., 8] by default)."""
    w = [(1.0 - t[..., d], t[..., d]) for d in range(3)]
    return torch.stack([w[0][i] * w[1][j] * w[2][k] for (i, j, k) in _CORNERS], dim=dim)


class HashEncoding(nn.Module):
    """x in [0,1]^3 -> [..., n_levels * n_features] encoding (level-major)."""

    def __init__(
        self,
        n_levels: int = 16,
        n_features: int = 2,
        log2_table_size: int = 19,
        base_res: int = 16,
        max_res: int = 2048,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.n_levels, self.n_features = n_levels, n_features
        self.table_size = 1 << log2_table_size
        self.dtype = dtype
        scale = per_level_scale(max_res, base_res, n_levels)
        res = _level_resolutions(base_res, scale, n_levels)
        self.resolutions = tuple(int(r) for r in res)
        self.table = nn.Parameter(torch.empty(n_levels, self.table_size, n_features))
        # per-level constants, made once so no call builds a device tensor
        self.register_buffer("_res_m1", torch.from_numpy((res - 1).astype(np.float32))[:, None, None], persistent=False)
        self.register_buffer("_res_i", torch.from_numpy(res)[:, None], persistent=False)
        self.register_buffer("_dense", torch.from_numpy(res**3 <= self.table_size)[:, None], persistent=False)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The flax init: uniform in [-1e-4, 1e-4]."""
        t = torch.empty(self.table.shape, dtype=torch.float32)
        t.uniform_(-1e-4, 1e-4, generator=generator)
        with torch.no_grad():
            self.table.copy_(t)

    def _vertex_cells(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [N, 3] in [0, 1] -> (corner idx [L, N, 8] int64, frac t [L, N, 3])."""
        idx, t = self._corner_cells(x)
        return idx.permute(0, 2, 1), t

    def _corner_cells(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`_vertex_cells` with the indices corner-major, [L, 8, N]: each
        corner's [L, N] block is written contiguously, and a level's slice
        is the contiguous index list of its gather."""
        mask = self.table_size - 1
        xl = x[None, :, :] * self._res_m1
        x0 = torch.floor(xl)
        t = xl - x0  # trilerp fractions in [0, 1)
        xi = x0.long()
        res = self._res_i  # [L, 1]
        hi = res - 1
        ax = []  # ax[d] = (coord at offset 0, coord at offset 1), each [L, N]
        for d in range(3):
            c = xi[..., d]
            ax.append((torch.minimum(c.clamp(min=0), hi), torch.minimum((c + 1).clamp(min=0), hi)))
        # per-axis terms of both index forms, so each corner is two adds or xors
        dense_t = [ax[0], tuple(res * c for c in ax[1]), tuple(res * res * c for c in ax[2])]
        hash_t = [tuple(c * _PRIMES[d] for c in ax[d]) for d in range(3)]
        corners = []
        for i, j, k in _CORNERS:
            dense_idx = dense_t[0][i] + dense_t[1][j] + dense_t[2][k]
            hash_idx = (hash_t[0][i] ^ hash_t[1][j] ^ hash_t[2][k]) & mask
            corners.append(torch.where(self._dense, dense_idx & mask, hash_idx))
        return torch.stack(corners, dim=1), t

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, 3).float()
        n, f = x2.shape[0], self.n_features
        idx, t = self._corner_cells(x2)
        w8 = _corner_weights(t, dim=1)  # [L, 8, N]
        outs = []
        for lvl in range(self.n_levels):  # gather from the [T, F] slice of each level
            feats = self.table[lvl].index_select(0, idx[lvl].reshape(-1)).view(8, n, f)
            outs.append((feats * w8[lvl][..., None]).sum(dim=0))
        out = torch.stack(outs, dim=1).reshape(n, self.n_levels * f)
        return out.reshape(*lead, self.n_levels * f).to(self.dtype)
