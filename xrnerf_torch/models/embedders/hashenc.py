"""Multiresolution hash encodings (Instant-NGP) — port of
``xrnerf_tpu/models/embedders/hashenc.py``: the vertex layout
(:class:`HashEncoding`) and the brick layout (:class:`BrickHashEncoding`),
each with its own autograd function, the counterparts of ``_vertex_lookup``
and ``_brick_lookup``.

Vertex layout: one stacked table parameter [L, T, F]; per level the 8
corners of the cell around a point are looked up and trilinearly
interpolated. Coarse levels whose dense grid fits under T are indexed
injectively, finer ones by NGP's spatial hash (tcnn's tied-grid behaviour);
the split is decided at construction in Python integers (2048^3 overflows
int32). Corner indices are computed for all levels at once, the rows
gathered per level from the [T, F] slice, as the JAX package does.

The hash is computed in int64 and masked to ``T - 1``: T is a power of two,
so the low bits equal the JAX package's wrapped-int32 product followed by a
non-negative ``% T``.

The table's gradient is the transpose of the gather, a row scatter-add: the
[L, N * 8, F] update rows ``corner weight x upstream gradient`` of all levels
go through one call of
:func:`xrnerf_torch.ops.scatter_rows.scatter_add_rows_levels` (one CUDA
launch on the card, ``index_add_`` on the CPU) into each level's
``min(res^3, T)`` rows, dense levels too: the JAX package's sorted-segment
and separable-splat paths are workarounds for a slow scatter and are not
here. The vertex forward keeps the corner indices and the fractions for the
backward (eight int64 indices and three f32 fractions, 76 bytes per point
and level); the gradient with respect to the positions is computed only when it
is asked for, from rows gathered again.

Brick layout: at hash(cell) one row of 8 * F lanes holds the features of all
8 corners of that cell, so a point reads one row per level and lattice
(``n_lattices`` staggered lattices, averaged or cross-faded). Table
[L, n_lattices, tb, 8 * F] with tb = 2^(log2_table_size - 3) / n_lattices:
the vertex table's parameter count. Its backward gathers again instead of
keeping rows, and scatters [L, N, 8 * F] rows with ``skip_zero_rows``, one
launch per lattice.

Under a mesh whose model axis holds M ranks (``parallel.mesh``; the
network's ``param_spec`` names the table), each rank holds rows
``[m T / M, (m + 1) T / M)`` of every level's bucket dimension (vertex T,
brick tb). A point's lookup gathers the corners that fall in the rank's
slice (zero elsewhere) and trilerps them: a partial encoding, summed over the
model group (``reduce_from``; the input goes through ``copy_to``, so the
positions' gradient is the sum of the partial ones). The backward scatters
into the slice alone: ids shifted by the slice's offset, the level row counts
of ``ops.scatter_rows.shard_rows``, so the kernel drops the rows of the other
slices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...ops.scatter_rows import scatter_add_rows_levels, shard_rows
from ...parallel.mesh import copy_to, model_group, reduce_from
from ...utils.dtype import resolve_dtype

# NGP's spatial hash primes (pi1 = 1 for x).
_PRIMES = (1, 2654435761, 805459861)

# corner offsets of a cell, k fastest: [8, 3]
_CORNERS = tuple((i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1))


def per_level_scale(max_res: int, base_res: int, n_levels: int) -> float:
    """Growth factor b = exp2(log2(max_res / base_res) / (L - 1))."""
    return float(np.exp2(np.log2(max_res / base_res) / max(n_levels - 1, 1)))


def _level_resolutions(base_res: int, scale: float, n_levels: int) -> np.ndarray:
    return np.floor(base_res * scale ** np.arange(n_levels)).astype(np.int64)


def _table_slice(enc: nn.Module, dim: int, full: int) -> Optional[Tuple[int, int]]:
    """(offset, rows) of the rank's slice of the table's bucket dimension
    ``dim`` when the table is cut over the model axis, None when whole."""
    rows = enc.table.shape[dim]
    return None if rows == full else (enc.mesh.model_rank * rows, rows)


def _sharded_forward(enc: nn.Module, lookup, x: torch.Tensor) -> torch.Tensor:
    """``lookup.apply(table, x, enc)`` on [N, 3]; under a model axis the
    partial encodings summed over its group."""
    group = model_group(enc)
    return reduce_from(lookup.apply(enc.table, copy_to(x, group), enc), group)


def _corner_weights(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """t [..., 3] -> trilerp weights, the 8 corners (order = _CORNERS)
    stacked along ``dim`` of the [...] shape ([..., 8] by default)."""
    w = [(1.0 - t[..., d], t[..., d]) for d in range(3)]
    return torch.stack([w[0][i] * w[1][j] * w[2][k] for (i, j, k) in _CORNERS], dim=dim)


class HashEncoding(nn.Module):
    """x in [0,1]^3 -> [..., n_levels * n_features] encoding (level-major)."""

    mesh = None  # set by parallel.mesh.shard_module

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
        self.dtype = resolve_dtype(dtype)
        scale = per_level_scale(max_res, base_res, n_levels)
        res = _level_resolutions(base_res, scale, n_levels)
        self.resolutions = tuple(int(r) for r in res)
        self.level_rows = tuple(min(r**3, self.table_size) for r in self.resolutions)  # V per level
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
        out = _sharded_forward(self, _VertexLookup, x.reshape(-1, 3).float())
        return out.reshape(*lead, self.n_levels * self.n_features).to(self.dtype)

    def _slice_rows(self, idx: torch.Tensor):
        """Global corner ids -> (ids shifted into the rank's slice, ids to
        gather, inside mask) of a cut table; (idx, idx, None) of a whole one."""
        sl = _table_slice(self, 1, self.table_size)
        if sl is None:
            return idx, idx, None
        local = idx - sl[0]
        return local, local.clamp(0, sl[1] - 1), (local >= 0) & (local < sl[1])


def _gather_trilerp(enc: "HashEncoding", table, idx, w8) -> torch.Tensor:
    """idx, w8 [L, 8, N] -> the encoding [N, L * F]: rows gathered per level
    from its [T, F] slice and summed with the corner weights."""
    n, f = idx.shape[2], enc.n_features
    outs = []
    for lvl in range(enc.n_levels):
        feats = table[lvl].index_select(0, idx[lvl].reshape(-1)).view(8, n, f)
        outs.append((feats * w8[lvl][..., None]).sum(dim=0))
    return torch.stack(outs, dim=1).reshape(n, enc.n_levels * f)


def _dweights_dt(t: torch.Tensor, gdot: torch.Tensor) -> torch.Tensor:
    """d(sum_c gdot_c * w_c) / dt for trilerp weights w(t): t [L, N, 3],
    gdot [L, N, 8] (corner order = _CORNERS) -> [L, N, 3]."""
    w = [(1.0 - t[..., d], t[..., d]) for d in range(3)]
    out = []
    for d in range(3):
        a, b = [e for e in range(3) if e != d]
        acc = 0.0
        for ci, corner in enumerate(_CORNERS):
            sign = 1.0 if corner[d] == 1 else -1.0
            acc = acc + sign * gdot[..., ci] * w[a][corner[a]] * w[b][corner[b]]
        out.append(acc)
    return torch.stack(out, dim=-1)


class _VertexLookup(torch.autograd.Function):
    """``_vertex_lookup`` (forward ``_vertex_impl``, backward ``_vertex_bwd``):
    table [L, T, F], x [N, 3] -> [N, L * F]."""

    @staticmethod
    def forward(ctx, table, x, enc):
        idx, t = enc._corner_cells(x)
        idx, gidx, inside = enc._slice_rows(idx)
        ctx.enc = enc
        ctx.save_for_backward(idx, t, table)
        w8 = _corner_weights(t, dim=1)
        return _gather_trilerp(enc, table, gidx, w8 if inside is None else w8 * inside)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        enc = ctx.enc
        idx, t, table = ctx.saved_tensors
        L, F, T = enc.n_levels, enc.n_features, table.shape[1]
        n = t.shape[1]
        g3 = g.reshape(n, L, F).float().permute(1, 0, 2)  # [L, N, F]
        grad_table = grad_x = None
        if ctx.needs_input_grad[0]:
            # [L, 8 * N, F] update rows, built for all levels at once, into each
            # level's V rows in one launch; a dense level occupies only res^3 < T
            # rows, the rest stay zero
            # (a cut table: ids outside the slice dropped, its level row counts)
            rows = (_corner_weights(t, dim=1)[..., None] * g3[:, None]).reshape(L, 8 * n, F)
            level_rows = enc.level_rows if T == enc.table_size else shard_rows(enc.level_rows, enc.mesh.model_rank * T, T)
            grad_table = scatter_add_rows_levels(idx.reshape(L, 8 * n), rows, level_rows, T).to(table.dtype)
        if ctx.needs_input_grad[1]:
            inside = None
            if T != enc.table_size:  # the partial form: corners outside the slice count zero
                inside = (idx >= 0) & (idx < T)
                idx = idx.clamp(0, T - 1)
            gdot = []
            for lvl in range(L):
                feats = table[lvl].index_select(0, idx[lvl].reshape(-1)).view(8, n, F)
                if inside is not None:
                    feats = feats * inside[lvl].reshape(8, n, 1)
                gdot.append((feats.float() * g3[lvl][None]).sum(dim=-1).t())  # [N, 8]
            dw = _dweights_dt(t, torch.stack(gdot))  # [L, N, 3]
            grad_x = (dw * enc._res_m1).sum(dim=0).to(t.dtype)
        return grad_table, grad_x, None


_BLEND_EPS = 1e-7


def _wrapped_mod(v: torch.Tensor, m: int) -> torch.Tensor:
    """``int32(v) % m`` with a non-negative result, for an int64 ``v`` whose
    low 32 bits are the wrapped-int32 value the JAX package computes."""
    if m & (m - 1) == 0:
        return v & (m - 1)
    low = v & 0xFFFFFFFF
    return torch.remainder(low - ((low >> 31) << 32), m)


class BrickHashEncoding(nn.Module):
    """Brick-layout encoding: x in [0,1]^3 -> [..., n_levels * n_features]
    with ``n_lattices`` row gathers per point and level instead of eight.
    ``blend='mean'`` averages the lattices; ``'smooth'`` weights lattice k by
    its face bump ``prod_d t_d (1 - t_d)``, normalised over the lattices."""

    mesh = None  # set by parallel.mesh.shard_module

    def __init__(
        self,
        n_levels: int = 16,
        n_features: int = 2,
        log2_table_size: int = 19,
        base_res: int = 16,
        max_res: int = 2048,
        n_lattices: int = 1,
        blend: str = "mean",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if blend not in ("mean", "smooth"):
            raise ValueError(f"blend must be 'mean' or 'smooth', got {blend!r}")
        self.n_levels, self.n_features, self.n_lattices = n_levels, n_features, n_lattices
        self.smooth = blend == "smooth" and n_lattices > 1
        self.rows = (1 << max(log2_table_size - 3, 4)) // n_lattices  # tb
        self.dtype = resolve_dtype(dtype)
        scale = per_level_scale(max_res, base_res, n_levels)
        res = _level_resolutions(base_res, scale, n_levels)
        self.resolutions = tuple(int(r) for r in res)
        self.table = nn.Parameter(torch.empty(n_levels, n_lattices, self.rows, 8 * n_features))
        self.register_buffer("_res_m1", torch.from_numpy((res - 1).astype(np.float32))[:, None, None], persistent=False)
        for k in range(n_lattices):  # lattice k: cells per axis res - 1 + k
            nc = res - 1 + k
            self.register_buffer(f"_nc_{k}", torch.from_numpy(nc)[:, None], persistent=False)
            self.register_buffer(f"_dense_{k}", torch.from_numpy(nc**3 <= self.rows)[:, None], persistent=False)
        self.register_buffer("_level_offs", (torch.arange(n_levels) * n_lattices * self.rows)[:, None], persistent=False)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The flax init: uniform in [-1e-4, 1e-4]."""
        t = torch.empty(self.table.shape, dtype=torch.float32)
        t.uniform_(-1e-4, 1e-4, generator=generator)
        with torch.no_grad():
            self.table.copy_(t)

    def _brick_cells(self, x: torch.Tensor, k: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [N, 3] in [0, 1] -> (row idx [L, N] int64, frac t [L, N, 3]).
        Lattice k is offset by k/2 of a cell: cell index floor(xl + k/2)."""
        nc = getattr(self, f"_nc_{k}")  # [L, 1]
        xl = x[None, :, :] * self._res_m1 + 0.5 * k
        c0 = torch.minimum(torch.floor(xl).clamp(min=0.0), (nc - 1).to(xl.dtype)[..., None])
        t = (xl - c0).clamp(0.0, 1.0)
        ci = c0.long()
        dense_idx = ci[..., 0] + nc * (ci[..., 1] + nc * ci[..., 2])
        hash_idx = ci[..., 0] * _PRIMES[0] ^ ci[..., 1] * _PRIMES[1] ^ ci[..., 2] * _PRIMES[2]
        idx = torch.where(getattr(self, f"_dense_{k}"), _wrapped_mod(dense_idx, self.rows), _wrapped_mod(hash_idx, self.rows))
        return idx, t

    def _brick_rows(self, table: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
        """One row per (level, point) of lattice k: idx [L, N] -> [L, N, 8, F].
        A cut table takes ids shifted into its slice; a row outside it reads
        zero."""
        L, n = idx.shape
        tb = table.shape[2]
        flat = table.reshape(L * self.n_lattices * tb, 8 * self.n_features)
        if tb == self.rows:
            fidx = (idx + self._level_offs + k * self.rows).reshape(-1)
            return flat.index_select(0, fidx).view(L, n, 8, self.n_features)
        offs = torch.arange(L, device=idx.device)[:, None] * (self.n_lattices * tb)
        fidx = (idx.clamp(0, tb - 1) + offs + k * tb).reshape(-1)
        inside = (idx >= 0) & (idx < tb)
        return flat.index_select(0, fidx).view(L, n, 8, self.n_features) * inside[..., None, None]

    def _lattices(self, table, x):
        """Per lattice: (idx, t, w8 [L, N, 8], rows, s [L, N, F] its trilerp);
        with a cut table, idx is shifted into the rank's slice."""
        sl = _table_slice(self, 2, self.rows)
        out = []
        for k in range(self.n_lattices):
            idx, t = self._brick_cells(x, k)
            if sl is not None:
                idx = idx - sl[0]
            rows = self._brick_rows(table, idx, k)
            w8 = _corner_weights(t)
            out.append((idx, t, w8, rows, (rows * w8[..., None]).sum(dim=2)))
        return out

    def _blend_weights(self, lat):
        """(u_k [L, N] per lattice, B [L, N]): the normalised face bumps."""
        betas = [_face_bump(t) for _, t, _, _, _ in lat]
        B = sum(betas) + _BLEND_EPS
        return [(b + _BLEND_EPS / self.n_lattices) / B for b in betas], B

    def _impl(self, table, x) -> torch.Tensor:
        lat = self._lattices(table, x)
        if self.smooth:
            us, _ = self._blend_weights(lat)
            out = sum(u[..., None] * l[4] for u, l in zip(us, lat))
        else:
            out = sum(l[4] for l in lat) / self.n_lattices
        return out.permute(1, 0, 2).reshape(x.shape[0], self.n_levels * self.n_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        out = _sharded_forward(self, _BrickLookup, x.reshape(-1, 3).float())
        return out.reshape(*lead, self.n_levels * self.n_features).to(self.dtype)


def _face_bump(t: torch.Tensor) -> torch.Tensor:
    """beta(t) = prod_d t_d (1 - t_d): vanishes on the lattice's cell faces."""
    b = t * (1.0 - t)
    return b[..., 0] * b[..., 1] * b[..., 2]


class _BrickLookup(torch.autograd.Function):
    """``_brick_lookup`` (forward ``_brick_impl``, backward ``_brick_bwd``):
    table [L, n_lat, tb, 8F], x [N, 3] -> [N, L * F]. Keeps (table, x) and
    gathers again in the backward."""

    @staticmethod
    def forward(ctx, table, x, enc):
        ctx.enc = enc
        ctx.save_for_backward(table, x)
        return enc._impl(table, x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        enc = ctx.enc
        table, x = ctx.saved_tensors
        L, F, K, tb = enc.n_levels, enc.n_features, enc.n_lattices, table.shape[2]
        n = x.shape[0]
        need_table, need_x = ctx.needs_input_grad[:2]
        g3 = g.reshape(n, L, F).float().permute(1, 0, 2)  # [L, N, F]
        lat = enc._lattices(table, x)
        if enc.smooth:
            us, B = enc._blend_weights(lat)
            out_blend = sum(u[..., None] * l[4] for u, l in zip(us, lat))
        grad_lat = []
        grad_x = torch.zeros_like(x) if need_x else None
        for k, (idx, t, w8, rows, s) in enumerate(lat):
            # d(out) / d(s_k): u_k for the smooth blend, 1 / K for the mean
            gk = g3 * us[k][..., None] if enc.smooth else g3 / K
            if need_table:
                gr = (w8[..., None] * gk[:, :, None, :]).reshape(L, n, 8 * F)
                grad_lat.append(scatter_add_rows_levels(idx, gr, [tb] * L, tb, skip_zero_rows=True))  # [L, tb, 8F]
            if need_x:
                gdot = (rows.float() * gk[:, :, None, :]).sum(dim=-1)  # [L, N, 8]
                grad_x = grad_x + (_dweights_dt(t, gdot) * enc._res_m1).sum(dim=0).to(x.dtype)
                if enc.smooth:
                    # through the blend weights: d(out) / d(beta_k) = (s_k - out) / B,
                    # d(beta) / dt_d = (1 - 2 t_d) * prod over the other axes of t (1 - t)
                    gb = ((s - out_blend) * g3).sum(dim=-1) / B  # [L, N]
                    bq = t * (1.0 - t)
                    dbeta = torch.stack([
                        (1.0 - 2.0 * t[..., 0]) * bq[..., 1] * bq[..., 2],
                        (1.0 - 2.0 * t[..., 1]) * bq[..., 0] * bq[..., 2],
                        (1.0 - 2.0 * t[..., 2]) * bq[..., 0] * bq[..., 1],
                    ], dim=-1)
                    grad_x = grad_x + (gb[..., None] * dbeta * enc._res_m1).sum(dim=0).to(x.dtype)
        grad_table = torch.stack(grad_lat, dim=1).to(table.dtype) if need_table else None
        return grad_table, grad_x, None
