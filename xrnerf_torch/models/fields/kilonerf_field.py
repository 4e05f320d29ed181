"""KiloNeRF multi-network field — port of
``xrnerf_tpu/models/fields/kilonerf_field.py``: thousands of tiny MLPs as
one batched product per layer.

KiloNeRF is a spatial mixture of experts. Each layer's weights are one
stacked parameter ``[n_nets, in, out]`` (bias ``[n_nets, 1, out]``), under
the JAX package's leaf names (``hidden_{i}_w/_b``, ``sigma_*``,
``feature_*``, ``color_hidden_*``, ``rgb_*``), so ``utils/weights.py``
carries them across as they are. Points go to their cell's network with
the mixture-of-experts capacity rule (stable sort by network, rank within
the group, drop past ``capacity``) and every layer is one ``torch.bmm``
over ``[n_nets, capacity, in]`` in f32, as the JAX package runs its
``dot_general`` (outside any Pallas kernel).

Two dispatches select the same slots:

- **scatter** (training, autograd): the raw 6-wide rows (points, directions)
  are written into a capacity buffer with ``index_put`` (no duplicate
  destination but the overflow slot, which is sliced off) and read back by
  ``dest``, each dropped point from a row of its own;
- **gather** (eval, no autograd): a stable ``argsort`` of the network ids
  and one row gather fill the buffer; the outputs come back in point order
  through the inverse permutation. The JAX version carries the rows
  through its sort as bitcast integer lanes, a TPU cost trick the port does
  not need.

Dropped and empty points get rgb 0 and sigma -1e3. The positional encoding
runs after grouping (on the capacity buffer), as in JAX.

Under a mesh (``parallel.mesh``):

- data axis: with a data-sharded step generator (``rows``) the capacity is
  the global batch's, and a point's rank within its network counts the
  network's points on lower data ranks first (one all-gather of an
  ``[n_nets]`` count vector), so the kept points are the one-process run's.
  Each rank's buffer is ``[n_nets, min(capacity, B_local)]``: every rank
  evaluates about the one-process buffer, D times its rows in all;
- model axis: model rank m holds networks ``[m N / M, (m + 1) N / M)`` of
  every stack (``KiloNerfNetwork.param_spec``), evaluates the kept points of
  those networks, gives the others zeros, and the outputs are summed over
  the model group; a dropped point's sigma of -1e3 comes from model rank 0.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...parallel.mesh import model_group, reduce_from, rows_before
from ..embedders.posenc import posenc, posenc_channels


def as_like(values, like: torch.Tensor) -> torch.Tensor:
    """``values`` in ``like``'s dtype on its device. A network passes its
    domain as buffers, which go through as they are; host numbers from a
    direct caller become a new tensor (a copy that waits for the card)."""
    return torch.as_tensor(values, dtype=like.dtype, device=like.device)


def assign_networks(
    pts: torch.Tensor, domain_min, domain_max, res: Sequence[int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Points [.., 3] -> (flat network index [..] int32, -1 out of the
    domain; local coordinates [.., 3] in [-1, 1] within the cell). Same op
    order as JAX: ``(pts - dmin) / (dmax - dmin)``, ``floor(rel * res)``,
    then the clip."""
    r0, r1, r2 = (int(r) for r in res)
    dmin, dmax = as_like(domain_min, pts), as_like(domain_max, pts)
    rel = (pts - dmin) / (dmax - dmin)
    # per axis, so no tensor is made from host values: the same f32 products as a [3] constant
    scaled = torch.stack([rel[..., a] * r for a, r in enumerate((r0, r1, r2))], dim=-1)
    vox = torch.floor(scaled).to(torch.int32)
    inb = torch.all((rel >= 0) & (rel < 1), dim=-1)
    v0, v1, v2 = (vox[..., a].clamp(0, r - 1) for a, r in enumerate((r0, r1, r2)))
    net_idx = v0 * (r1 * r2) + v1 * r2 + v2
    local = (scaled - torch.stack([v0, v1, v2], dim=-1)) * 2.0 - 1.0
    return torch.where(inb, net_idx, -1), local


def moe_dispatch(net_idx: torch.Tensor, n_nets: int, capacity: int, rows=None,
                 nets: Optional[Tuple[int, int]] = None, slots: Optional[int] = None):
    """[B] indices (-1 = dropped) -> (dest slot [B], keep mask [B], order [B])
    in sorted order: ``order`` sorts the points by network (stably, the
    dropped ones last), ``dest[j]`` is sorted point j's slot in the
    ``[n_nets * capacity]`` buffer (``n_nets * capacity`` if not kept).

    A rank of a sharded batch passes ``rows`` (a step generator's: a point
    is kept while its rank among its network's points in global order, those
    on lower data ranks first, is below the capacity), its networks
    ``nets = (lo, hi)`` and its buffer's ``slots`` per network: then ``dest`` indexes the
    ``[(hi - lo) * slots]`` buffer (its size where the point is not kept or
    not the rank's), while ``keep`` is the global rule's."""
    b = net_idx.shape[0]
    key = torch.where(net_idx >= 0, net_idx, n_nets).to(torch.int32)
    sorted_key, order = torch.sort(key, stable=True)
    groups = torch.arange(n_nets + 1, dtype=torch.int32, device=net_idx.device)
    first = torch.searchsorted(sorted_key, groups, side="left").to(torch.int32)
    net = sorted_key.clamp(0, n_nets).long()
    rank = torch.arange(b, dtype=torch.int32, device=net_idx.device) - first[net]
    held = rank
    if rows is not None:  # each network's points on lower data ranks come first
        before = rows_before(first[1:] - first[:-1], rows)
        held = rank + torch.cat([before, before.new_zeros(1)])[net]
    keep = (sorted_key < n_nets) & (held < capacity)
    lo, hi = nets if nets is not None else (0, n_nets)
    mine = keep if (lo, hi) == (0, n_nets) else keep & (sorted_key >= lo) & (sorted_key < hi)
    slots = capacity if slots is None else slots
    return torch.where(mine, (sorted_key - lo if lo else sorted_key) * slots + rank, (hi - lo) * slots), keep, order


def _init_layer(w: torch.Tensor, b: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """Kaiming-uniform fan-in weights (bound sqrt(6 / d_in)), zero biases."""
    bound = math.sqrt(6.0 / w.shape[1])
    with torch.no_grad():
        w.copy_((torch.rand(w.shape, generator=generator, dtype=torch.float32) * 2 - 1) * bound)
        b.zero_()


class _StackedMLP(nn.Module):
    """The per-network layers shared by :class:`MultiNetworkMLP` and
    :class:`GroupedMultiMLP`: fourier-embedded points -> ``n_hidden_layers``
    hidden layers -> sigma and feature; the direction embedding joins the
    feature for one more hidden layer and the rgb head."""

    def __init__(self, n_nets: int, hidden: int = 32, n_hidden_layers: int = 2, multires: int = 10,
                 multires_dirs: int = 4):
        super().__init__()
        self.n_nets, self.hidden, self.n_hidden_layers = n_nets, hidden, n_hidden_layers
        self.multires, self.multires_dirs = multires, multires_dirs
        pts_ch = posenc_channels(3, multires)
        dir_ch = posenc_channels(3, multires_dirs)
        dims = [(f"hidden_{i}", pts_ch if i == 0 else hidden, hidden) for i in range(n_hidden_layers)]
        dims += [("sigma", hidden, 1), ("feature", hidden, hidden), ("color_hidden", hidden + dir_ch, hidden),
                 ("rgb", hidden, 3)]
        self.layers = [name for name, _, _ in dims]
        for name, d_in, d_out in dims:
            self.register_parameter(f"{name}_w", nn.Parameter(torch.empty(n_nets, d_in, d_out)))
            self.register_parameter(f"{name}_b", nn.Parameter(torch.zeros(n_nets, 1, d_out)))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for name in self.layers:
            _init_layer(getattr(self, f"{name}_w"), getattr(self, f"{name}_b"), generator)

    def _layer(self, name: str, x: torch.Tensor, relu: bool = True) -> torch.Tensor:
        y = torch.baddbmm(getattr(self, f"{name}_b"), x, getattr(self, f"{name}_w"))
        return F.relu(y) if relu else y

    def _mlp(self, h: torch.Tensor, d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Encoded points h [N, E, pts_ch], encoded directions d [N, E, dir_ch]
        -> raw (rgb [N, E, 3], sigma [N, E])."""
        for i in range(self.n_hidden_layers):
            h = self._layer(f"hidden_{i}", h)
        sigma = self._layer("sigma", h, relu=False)[..., 0]
        feat = self._layer("feature", h, relu=False)
        hd = self._layer("color_hidden", F.relu(torch.cat([feat, d], dim=-1)))
        return self._layer("rgb", hd, relu=False), sigma


class MultiNetworkMLP(_StackedMLP):
    """Stacked tiny MLPs evaluated by batched products over dispatched points."""

    mesh = None  # set by parallel.mesh.shard_module

    def __init__(self, n_nets: int, hidden: int = 32, n_hidden_layers: int = 2, multires: int = 10,
                 multires_dirs: int = 4, capacity_factor: float = 2.0):
        super().__init__(n_nets, hidden, n_hidden_layers, multires, multires_dirs)
        self.capacity_factor = capacity_factor

    def capacity(self, bsz: int) -> int:
        return min(int(max(8, self.capacity_factor * bsz / max(self.n_nets, 1))), bsz)

    def _nets(self) -> Tuple[int, int]:
        """The networks ``[lo, hi)`` whose weights this rank holds."""
        n_local = self.rgb_w.shape[0]
        lo = self.mesh.model_rank * n_local if n_local != self.n_nets else 0
        return lo, lo + n_local

    def forward(
        self, local_pts: torch.Tensor, dirs: torch.Tensor, net_idx: torch.Tensor, gather_dispatch: bool = False,
        rows=None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """local_pts [B, 3] in [-1, 1], dirs [B, 3], net_idx [B] (-1 = empty)
        -> (raw_rgb [B, 3], raw_sigma [B]). ``rows`` (a step generator's
        ``rows``) makes the capacity rule the global batch's."""
        if gather_dispatch:
            return self._gather_dispatch(local_pts, dirs, net_idx)
        bsz = local_pts.shape[0]
        lo, hi = self._nets()
        cap = self.capacity(bsz * (rows.size if rows is not None else 1))
        slots = min(cap, bsz)  # the capacity, for one process
        dest, keep, order = moe_dispatch(net_idx, self.n_nets, cap, rows, (lo, hi), slots)
        n_local = hi - lo
        dest = dest.long()
        mine = dest < n_local * slots
        raw = torch.cat([local_pts, dirs], dim=-1)  # [B, 6]
        buf = raw.new_zeros(n_local * slots + 1, 6)
        buf = buf.index_put((dest,), torch.where(mine[:, None], raw[order], 0.0))
        rgb, sigma = self._eval_grouped(buf[:-1].view(n_local, slots, 6))
        # back to point order. A dropped point reads a row of its own past the buffer, (0, 0, 0, -1e3), so
        # that no index repeats: the gradient of a gather is a scatter-add, and the adds of every dropped
        # point into one shared row would serialise (100 ms a step when most samples are empty). A kept
        # point of another model rank's network reads zeros; the model group's sum fills it in.
        y = torch.cat([rgb.reshape(-1, 3), sigma.reshape(-1, 1)], dim=-1)
        pad = y.new_zeros(bsz, 4)
        pad[:, 3] = torch.where(keep, 0.0, self._dropped_sigma())
        src = torch.where(mine, dest, n_local * slots + torch.arange(bsz, device=dest.device))
        out = torch.cat([y, pad]).index_select(0, src)  # sorted order
        out = reduce_from(out.new_empty(bsz, 4).index_put((order,), out), model_group(self))
        return out[:, :3], out[:, 3]

    def _dropped_sigma(self) -> float:
        """-1e3, from model rank 0 alone where the model group sums."""
        return -1e3 if self.mesh is None or self.mesh.model_rank == 0 else 0.0

    def _gather_dispatch(self, local_pts, dirs, net_idx):
        """The eval dispatch: sort, one row gather into the capacity buffer,
        one row gather back. Selects the scatter dispatch's slots."""
        bsz, cap, n = local_pts.shape[0], self.capacity(local_pts.shape[0]), self.n_nets
        lo, hi = self._nets()
        dev = local_pts.device
        key = torch.where(net_idx >= 0, net_idx, n).to(torch.int32)
        skey, perm = torch.sort(key, stable=True)
        first = torch.searchsorted(skey, torch.arange(n + 1, dtype=torch.int32, device=dev), side="left")
        pos = first[lo:hi, None] + torch.arange(cap, device=dev)[None, :]  # [n, cap] sorted row of slot (e, r)
        valid_slot = pos < torch.minimum(first[lo + 1:hi + 1, None], first[lo:hi, None] + cap)
        src = torch.cat([perm, perm.new_full((1,), bsz)])[torch.where(valid_slot, pos.clamp(max=bsz - 1), bsz)]
        raw = torch.cat([torch.cat([local_pts, dirs], dim=-1), local_pts.new_zeros(1, 6)])
        rgb, sigma = self._eval_grouped(raw[src].view(hi - lo, cap, 6))
        rank = torch.arange(bsz, device=dev) - first[skey.clamp(0, n).long()]
        kept = (skey < n) & (rank < cap)
        mine = kept & (skey >= lo) & (skey < hi)
        # slot, or past the buffer: row (hi - lo) cap is a dropped point's (0, 0, 0, -1e3), the next another rank's
        dest = torch.where(mine, (skey - lo) * cap + rank, torch.where(kept, (hi - lo) * cap + 1, (hi - lo) * cap))
        dest_orig = torch.empty_like(dest).scatter_(0, perm, dest)  # dest in point order
        out4 = torch.cat([rgb.reshape(-1, 3), sigma.reshape(-1, 1)], dim=-1)
        pad = out4.new_zeros(2, 4)
        pad[0, 3] = self._dropped_sigma()
        o4 = reduce_from(torch.cat([out4, pad])[dest_orig.long()], model_group(self))
        return o4[:, :3], o4[:, 3]

    def _eval_grouped(self, grouped_raw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[N_nets, cap, 6] raw (points, directions) -> (rgb [N, cap, 3],
        sigma [N, cap]); the encodings are made here, after grouping."""
        return self._mlp(posenc(grouped_raw[..., :3], self.multires), posenc(grouped_raw[..., 3:], self.multires_dirs))


class GroupedMultiMLP(_StackedMLP):
    """Multi-network eval over pre-grouped examples [N_nets, E, ...] (the
    distillation phase draws every network's examples in its own domain, so
    no dispatch is needed). Same leaf names as :class:`MultiNetworkMLP`, so
    fitted weights go into the finetune field as they are."""

    def forward(self, local_pts: torch.Tensor, dirs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """local_pts [N, E, 3] in [-1, 1], dirs [N, E, 3] -> raw (rgb [N, E, 3], sigma [N, E])."""
        return self._mlp(posenc(local_pts, self.multires), posenc(dirs, self.multires_dirs))
