"""KiloNeRF: finetune network, distillation student, occupancy-grid sweep —
port of ``xrnerf_tpu/models/networks/kilonerf.py``.

- Three empty-space-skipping (ESS) marches over one z-lattice of
  ``n_candidates`` steps per ray, each keeping the first ``n_keep`` live
  samples: ``kilonerf_march`` (every candidate against the grid),
  ``kilonerf_sphere_march`` (jumps through empty space by an L-inf distance
  field, one step per loop turn) and ``kilonerf_pooled_march`` (stage A tests
  group centres against dilated occupancy bitfields, stage B the kept groups'
  candidates against the grid). ``kilonerf_strip_active`` is the renderer's
  conservative ray-culling prepass.
- ``KiloNerfNetwork``: training renders the stratified samples through the
  scatter dispatch and ``volume_render``; eval with an occupancy grid marches,
  optionally compacts the live samples to ``eval_budget`` slots, evaluates
  them through the gather dispatch and composites with the candidate step.
  Its occupancy grid (the JAX trainer's aux) is a buffer, so checkpoints and
  weight files carry it; the distance field and the packed bitfields are
  made once per grid, where JAX remakes them inside every chunk.
- ``StudentNerfNetwork`` and ``build_occupancy_grid`` (the teacher's density
  swept plane by plane, thresholded, any-pooled).

Known behaviours of both packages, kept as they are: past ``r > RMAX`` the
pooled march keeps the first ``n_groups_keep`` in-bounds groups blindly;
the capacity rule drops points of crowded networks.

Under a mesh (``parallel.mesh``) ``param_spec`` cuts every expert stack's
network dimension over the model axis (expert parallelism, as the JAX
network's does); ``param_loss`` sums its slices' squares over the model
group; a training step's capacity rule is the global batch's
(``MultiNetworkMLP``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.compaction import keep_first_k
from ...parallel.mesh import MODEL_AXIS, model_group, reduce_from
from ...registry import NETWORKS
from ...utils.device import resolve_device
from ...utils.metrics import img2mse, mse2psnr
from ..fields.kilonerf_field import MultiNetworkMLP, as_like, assign_networks
from ..renders.volume import volume_render
from ..samplers.stratified import sample_along_rays, z_to_pts

RMAX = 6  # pooled march: largest dilation radius with a packed bitfield


def _lattice(n: int, like: torch.Tensor) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)``'s f32 values: XLA divides by the constant
    n - 1 as a product with its reciprocal, i * fl(1 / (n - 1))."""
    return torch.arange(n, dtype=like.dtype, device=like.device) * (1.0 / max(n - 1, 1))


def _flat_cells(rel: torch.Tensor, ores: Sequence[int]) -> torch.Tensor:
    """Relative coordinates [..., 3] -> flat cell index [...] (clipped)."""
    o0, o1, o2 = ores
    c0, c1, c2 = (torch.floor(rel[..., a] * int(o)).to(torch.int64).clamp(0, int(o) - 1) for a, o in enumerate(ores))
    return c0 * (o1 * o2) + c1 * o2 + c2


def _min_cell_edge(extent: torch.Tensor, ores: Sequence[int]) -> torch.Tensor:
    """The shortest edge of a cell of the grid of shape ``ores`` over ``extent``."""
    return torch.stack([extent[a] / int(o) for a, o in enumerate(ores)]).min()


def _keep_front(z: torch.Tensor, live: torch.Tensor, far: torch.Tensor, n_keep: int):
    """The first ``n_keep`` live samples of each ray in z order (dead ones
    last, stably): (z_keep [N, K] with ``far`` where dead, mask [N, K])."""
    key = torch.where(live, z, torch.full_like(z, float("inf")))
    order = torch.sort(key, dim=-1, stable=True).indices[:, :n_keep]
    z_keep = torch.gather(z, 1, order)
    mask = torch.gather(live, 1, order)
    return torch.where(mask, z_keep, far), mask


def kilonerf_march(rays_o, rays_d, near, far, occ, domain_min, domain_max, n_candidates: int, n_keep: int):
    """Keep-K ESS march testing every candidate of the endpoint lattice
    (``sample_along_rays(perturb=False)``'s positions) against the grid.
    Returns (z_keep [N, K], mask [N, K], dt [N, 1])."""
    S = n_candidates
    z = near + (far - near) * _lattice(S, rays_o)[None, :]  # [N, S]
    dt = (far - near) / max(S - 1, 1)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    dmin, dmax = as_like(domain_min, pts), as_like(domain_max, pts)
    rel = (pts - dmin) / (dmax - dmin)
    inb = torch.all((rel >= 0) & (rel < 1), dim=-1)
    live = occ.reshape(-1)[_flat_cells(rel, occ.shape)] & inb
    z_keep, mask = _keep_front(z, live, far, n_keep)
    return z_keep, mask, dt


def distance_transform_linf(occ: torch.Tensor, max_d: int = 15) -> torch.Tensor:
    """L-inf (chessboard) distance in cells to the nearest occupied cell,
    capped at ``max_d``: ``max_d`` rounds of a separable 3-wide
    min-erosion (a max-pool of the negated field per axis)."""
    d = torch.where(occ, 0.0, float(max_d)).to(torch.float32)[None, None]
    for _ in range(max_d):
        m = d
        for kernel in ((3, 1, 1), (1, 3, 1), (1, 1, 3)):
            m = -F.max_pool3d(-m, kernel, stride=1, padding=tuple(k // 2 for k in kernel))
        d = torch.minimum(d, m + 1)
    return d[0, 0].to(torch.int32)


class KiloAux(NamedTuple):
    """Eval aux: occupancy and its L-inf distance field (made once per grid)."""

    occ: torch.Tensor  # [ox, oy, oz] bool
    dist: torch.Tensor  # [ox, oy, oz] int32


def prepare_march_aux(occ: torch.Tensor) -> KiloAux:
    return KiloAux(occ=occ, dist=distance_transform_linf(occ))


def kilonerf_sphere_march(rays_o, rays_d, near, far, occ, domain_min, domain_max, n_candidates: int, n_keep: int,
                          n_steps: int = 96, dist: Optional[torch.Tensor] = None):
    """Sphere-trace ESS march: ``n_steps`` lookups of the distance field per
    ray, each jumping whole lattice steps through empty space (at least
    one). Positions stay on the dense march's lattice, so with a step budget
    that covers the ray the kept samples are the dense march's."""
    S = n_candidates
    dt = (far - near) / max(S - 1, 1)
    dt1 = dt[:, 0].clamp(min=1e-9)
    world_dt = dt1 * torch.linalg.norm(rays_d, dim=-1).clamp(min=1e-9)
    dmin, dmax = as_like(domain_min, rays_o), as_like(domain_max, rays_o)
    extent = dmax - dmin
    ores = tuple(int(v) for v in occ.shape)
    min_edge = _min_cell_edge(extent, ores)
    if dist is None:
        dist = distance_transform_linf(occ)
    flat_dist = dist.reshape(-1)
    # start at the ray's entry into the domain (slab test), snapped up to the lattice
    safe_d = torch.where(rays_d.abs() > 1e-9, rays_d, torch.full_like(rays_d, 1e-9))
    t0, t1 = (dmin - rays_o) / safe_d, (dmax - rays_o) / safe_d
    t_enter = torch.amax(torch.minimum(t0, t1), dim=-1)
    # clipped before the cast, which saturates as XLA's does (torch's cast of an out-of-range float does not)
    k = torch.ceil((t_enter - near[:, 0]) / dt1 - 1e-4).clamp(0, S).to(torch.int32)
    zs, lives = [], []
    for _ in range(n_steps):
        # XLA compiles the JAX loop body as one fusion and contracts a + b * c
        # into a fused multiply-add; ``addcmul`` is one too, on the CPU and the card
        t = torch.addcmul(near[:, 0], k.to(rays_o.dtype), dt1)
        p = torch.addcmul(rays_o, rays_d, t[:, None])
        rel = (p - dmin) / extent
        inb = torch.all((rel >= 0) & (rel < 1), dim=-1) & (k < S)
        d = flat_dist[_flat_cells(rel, ores)]
        skip = torch.floor((d - 1).clamp(min=0).to(rays_o.dtype) * min_edge / world_dt).to(torch.int32)
        k = k + torch.where(inb, skip, 1).clamp(min=1)
        zs.append(t)
        lives.append(inb & (d == 0))
    z_keep, mask = _keep_front(torch.stack(zs, 1), torch.stack(lives, 1), far, n_keep)
    return z_keep, mask, dt


def _pack_z_bits(bits: torch.Tensor) -> torch.Tensor:
    """[ox, oy, oz] bool -> [ox*oy, ceil(oz/32)] int64 words, bit z & 31 of
    word z >> 5 = bits[x, y, z] (int64: torch has no uint32 arithmetic)."""
    ox, oy, oz = bits.shape
    wz = (oz + 31) // 32
    b = F.pad(bits.to(torch.int64), (0, wz * 32 - oz)).reshape(ox * oy, wz, 32)
    w = torch.bitwise_left_shift(torch.ones(32, dtype=torch.int64, device=bits.device),
                                 torch.arange(32, dtype=torch.int64, device=bits.device))
    return (b * w).sum(-1)


def _zrow_bit(rows: torch.Tensor, cz: torch.Tensor) -> torch.Tensor:
    """rows [..., WZ] packed z-columns, cz [...] -> bool, bit cz of the column."""
    word = torch.gather(rows, -1, (cz >> 5).to(torch.int64)[..., None])[..., 0]
    return ((word >> (cz & 31).to(torch.int64)) & 1).to(torch.bool)


class MarchTables(NamedTuple):
    """The pooled march's packed bitfields (made once per grid)."""

    dil_packed: torch.Tensor  # [RMAX * ox * oy, WZ]: dist <= r for r = 1..RMAX
    occ_packed: torch.Tensor  # [ox * oy, WZ]


def pack_march_tables(occ: torch.Tensor, dist: torch.Tensor) -> MarchTables:
    return MarchTables(torch.cat([_pack_z_bits(dist <= r) for r in range(1, RMAX + 1)], 0), _pack_z_bits(occ))


def kilonerf_pooled_march(rays_o, rays_d, near, far, occ, domain_min, domain_max, n_candidates: int, n_keep: int,
                          group: int = 8, n_groups_keep: int = 8, dist: Optional[torch.Tensor] = None,
                          tables: Optional[MarchTables] = None):
    """Two-stage ESS march over the dense march's lattice, no loop and no sort:

    stage A  one centre per ``group`` candidates is tested against the
             dilated occupancy (dist <= r, r the cells a group's half-extent
             covers, per ray); the first ``n_groups_keep`` live groups are kept;
    stage B  their candidates are tested against the grid itself, and the
             first ``n_keep`` live ones kept.

    Kept samples equal the dense march's whenever the kept groups hold them.
    Tensors are planar, [steps, N]."""
    n = rays_o.shape[0]
    S, G, Kg = n_candidates, group, n_groups_keep
    assert S % G == 0, "n_candidates must be a multiple of group"
    SG = S // G
    o0, o1, o2 = (int(v) for v in occ.shape)
    dt = (far - near) / max(S - 1, 1)
    dt1 = dt[:, 0].clamp(min=1e-9)
    dnorm = torch.linalg.norm(rays_d, dim=-1)
    dmin, dmax = as_like(domain_min, rays_o), as_like(domain_max, rays_o)
    extent = dmax - dmin
    min_edge = _min_cell_edge(extent, (o0, o1, o2))
    if tables is None:
        tables = pack_march_tables(occ, distance_transform_linf(occ) if dist is None else dist)
    near1 = near[:, 0]

    def cells_planar(z):  # z [Q, N] -> per-axis cells [3][Q, N], relative coordinates [3][Q, N]
        cids, rels = [], []
        for ax, orr in enumerate((o0, o1, o2)):
            rel = (rays_o[None, :, ax] + rays_d[None, :, ax] * z - dmin[ax]) / extent[ax]
            rels.append(rel)
            cids.append(torch.floor(rel * orr).to(torch.int64).clamp(0, orr - 1))
        return cids, rels

    # stage A: group centres against the dilated-occupancy bitfields
    gc = torch.arange(SG, dtype=rays_o.dtype, device=rays_o.device) * G + (G - 1) / 2.0
    zc = near1[None, :] + gc[:, None] * dt1[None, :]  # [SG, N]
    cidsc, relsc = cells_planar(zc)
    half_w = (G - 1) / 2.0 * dt1 * dnorm  # [N] world half-extent of a group
    r = torch.floor(half_w / min_edge).to(torch.int64) + 1
    inb_c = torch.ones_like(zc, dtype=torch.bool)
    for ax, rel in enumerate(relsc):
        m = (half_w / extent[ax])[None, :]
        inb_c &= (rel >= -m) & (rel < 1 + m)
    row_a = (r.clamp(1, RMAX) - 1)[None, :] * (o0 * o1) + cidsc[0] * o1 + cidsc[1]
    bit_a = _zrow_bit(tables.dil_packed[row_a], cidsc[2])
    live_a = inb_c & (bit_a | (r > RMAX)[None, :])
    gidx, gmask = keep_first_k(live_a.T, Kg)  # [N, Kg]

    # stage B: the kept groups' candidates against the grid
    s_idx = (gidx[:, :, None] * G + torch.arange(G, dtype=torch.int32, device=rays_o.device)).reshape(n, Kg * G)
    s_t = s_idx.T  # [Kg*G, N]
    z_b = near1[None, :] + s_t.to(rays_o.dtype) * dt1[None, :]
    cids_b, rels_b = cells_planar(z_b)
    inb = torch.ones_like(z_b, dtype=torch.bool)
    for rel in rels_b:
        inb &= (rel >= 0) & (rel < 1)
    bit_b = _zrow_bit(tables.occ_packed[cids_b[0] * o1 + cids_b[1]], cids_b[2])
    gmask_b = gmask[:, :, None].expand(n, Kg, G).reshape(n, Kg * G).T
    live_b = bit_b & inb & gmask_b & (s_t < S)
    _, mask, z_keep = keep_first_k(live_b.T, n_keep, vals=z_b.T)
    return torch.where(mask, z_keep, far), mask, dt


def kilonerf_strip_active(rays_o, rays_d, near, far, dist, domain_min, domain_max, strip: int = 16,
                          n_probes: int = 48) -> torch.Tensor:
    """Conservative frame-level ray culling: [N] bool, False only for rays
    that provably have no occupied sample. Strips of ``strip`` consecutive
    rays share one probe march along their mean ray, ``n_probes`` lookups
    of the distance field, with the probe radius inflated by the strip's
    exact worst-case spread (sound for linear rays; see the JAX version)."""
    n = rays_o.shape[0]
    pad = (-n) % strip
    if pad:  # repeat the last ray; the strip holding the copies stays conservative
        rays_o, rays_d, near, far = (torch.cat([t, t[-1:].expand(pad, t.shape[1])]) for t in (rays_o, rays_d, near, far))
    ns = (n + pad) // strip
    ro, rd = rays_o.reshape(ns, strip, 3), rays_d.reshape(ns, strip, 3)
    t0 = torch.amin(near.reshape(ns, strip), dim=1)
    t1 = torch.amax(far.reshape(ns, strip), dim=1)
    oc, dc = ro.mean(1), rd.mean(1)
    do_, dd = ro - oc[:, None], rd - dc[:, None]
    spread = torch.maximum(torch.amax((do_ + t0[:, None, None] * dd).abs(), dim=(1, 2)),
                           torch.amax((do_ + t1[:, None, None] * dd).abs(), dim=(1, 2)))
    seg = (t1 - t0) / n_probes
    R = spread + 0.5 * seg * torch.amax(dc.abs(), dim=-1)  # [ns] world L-inf probe radius
    ores = tuple(int(v) for v in dist.shape)
    dmin, dmax = as_like(domain_min, rays_o), as_like(domain_max, rays_o)
    extent = dmax - dmin
    r = torch.floor(R / _min_cell_edge(extent, ores)).to(torch.int32) + 1
    tm = t0[:, None] + (torch.arange(n_probes, dtype=rays_o.dtype, device=rays_o.device) + 0.5) * seg[:, None]
    p = oc[:, None, :] + dc[:, None, :] * tm[..., None]  # [ns, P, 3]
    rel = (p - dmin) / extent
    m = (R[:, None] / extent)[:, None, :]
    inb = torch.all((rel >= -m) & (rel < 1 + m), dim=-1)
    hit = inb & (dist.reshape(-1)[_flat_cells(rel, ores)] <= r[:, None])
    return hit.any(-1)[:, None].expand(ns, strip).reshape(-1)[:n]


@NETWORKS.register
class KiloNerfNetwork(nn.Module):
    """Finetune/inference network over a fixed grid of tiny MLPs."""

    def __init__(
        self,
        resolution: Sequence[int] = (16, 16, 16),
        domain_min: Sequence[float] = (-1.0, -1.0, -1.0),
        domain_max: Sequence[float] = (1.0, 1.0, 1.0),
        hidden: int = 32,
        n_hidden_layers: int = 2,
        multires: int = 10,
        multires_dirs: int = 4,
        n_samples: int = 384,
        n_keep: int = 32,  # eval ESS budget; 0 = evaluate all n_samples
        march: str = "dense",  # 'dense' | 'sphere' | 'pooled'
        n_march_steps: int = 96,
        march_group: int = 8,
        march_groups_keep: int = 8,
        eval_budget: int = 0,  # live-first samples reaching the dispatch per chunk; 0 = all
        capacity_factor: float = 2.0,
        white_bkgd: bool = True,
        view_dep_reg: float = 1e-6,
        occupancy_path: str = "",
    ):
        super().__init__()
        self.resolution = tuple(int(r) for r in resolution)
        self.domain_min, self.domain_max = tuple(domain_min), tuple(domain_max)
        # the domain on the network's device, so no step or chunk copies it from the host
        self.register_buffer("domain_lo", torch.tensor(self.domain_min, dtype=torch.float32), persistent=False)
        self.register_buffer("domain_hi", torch.tensor(self.domain_max, dtype=torch.float32), persistent=False)
        self.n_samples, self.n_keep, self.march = n_samples, n_keep, march
        self.n_march_steps, self.march_group, self.march_groups_keep = n_march_steps, march_group, march_groups_keep
        self.eval_budget, self.white_bkgd = eval_budget, white_bkgd
        self.view_dep_reg, self.occupancy_path = view_dep_reg, occupancy_path
        self.mlp = MultiNetworkMLP(int(np.prod(self.resolution)), hidden, n_hidden_layers, multires, multires_dirs,
                                   capacity_factor)
        # the occupancy grid (JAX: the trainer's aux), and what the marches derive from it
        self.register_buffer("occupancy", None)
        for name in ("occ_dist", "dil_packed", "occ_packed"):
            self.register_buffer(name, None, persistent=False)

    @property
    def n_nets(self) -> int:
        return self.mlp.n_nets

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.mlp.reset_parameters(generator)

    # -- aux: the occupancy grid ----------------------------------------------
    def set_occupancy(self, occ) -> None:
        """Install a bool grid [ox, oy, oz] (numpy or tensor) on the
        network's device, with its distance field and packed bitfields."""
        aux = prepare_march_aux(torch.as_tensor(occ).to(self.mlp.rgb_w.device, torch.bool).contiguous())
        self.occupancy, self.occ_dist = aux
        self.dil_packed, self.occ_packed = pack_march_tables(*aux)

    def init_aux(self, dataset=None) -> None:
        """The grid from the occupancy phase's ``.npy`` file, when the config names one."""
        if self.occupancy_path:
            self.set_occupancy(np.load(self.occupancy_path))

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict, missing_keys, unexpected_keys,
                              error_msgs):
        """A state dict's grid replaces the network's; one without a grid
        leaves the network's as it is (as JAX's ``load_from`` keeps the aux)."""
        key = prefix + "occupancy"
        if state_dict.get(key) is not None:
            self.set_occupancy(state_dict[key])
        super()._load_from_state_dict(state_dict, prefix, local_metadata, strict, missing_keys, unexpected_keys,
                                      error_msgs)
        if key in missing_keys:
            missing_keys.remove(key)

    # -- forward ------------------------------------------------------------
    def forward(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                train: bool = False) -> Dict[str, torch.Tensor]:
        if train:
            return self._forward(batch, generator, train=True)
        with torch.inference_mode():
            return self._forward(batch, None, train=False)

    def _forward(self, batch, generator, train: bool) -> Dict[str, torch.Tensor]:
        rays_o, rays_d, near, far = batch["rays_o"], batch["rays_d"], batch["near"], batch["far"]
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        occ = self.occupancy
        if not train and occ is not None and self.n_keep > 0:
            return self._render_fast(batch, viewdirs)
        z_vals = sample_along_rays(near, far, self.n_samples, perturb=train, generator=generator if train else None)
        pts = z_to_pts(rays_o, rays_d, z_vals)
        n, s, _ = pts.shape
        flat = pts.reshape(n * s, 3)
        net_idx, local = assign_networks(flat, self.domain_lo, self.domain_hi, self.resolution)
        if occ is not None:  # points in unoccupied cells become inactive
            rel = (flat - self.domain_lo) / (self.domain_hi - self.domain_lo)
            net_idx = torch.where(occ.reshape(-1)[_flat_cells(rel, occ.shape)], net_idx, -1)
        dirs_flat = viewdirs[:, None].expand(n, s, 3).reshape(n * s, 3)
        raw_rgb, raw_sigma = self.mlp(local, dirs_flat, net_idx, rows=getattr(generator, "rows", None))
        ret = volume_render(raw_rgb.reshape(n, s, 3), raw_sigma.reshape(n, s), z_vals, rays_d,
                            white_bkgd=self.white_bkgd)
        return {k: ret[k] for k in ("rgb", "disp", "acc", "depth")}

    def march_samples(self, batch: Dict[str, torch.Tensor]):
        """The configured march over the network's grid: (z_keep, mask, dt)."""
        args = (batch["rays_o"], batch["rays_d"], batch["near"], batch["far"], self.occupancy,
                self.domain_lo, self.domain_hi, self.n_samples, self.n_keep)
        if self.march == "pooled":
            return kilonerf_pooled_march(*args, group=self.march_group, n_groups_keep=self.march_groups_keep,
                                         tables=MarchTables(self.dil_packed, self.occ_packed))
        if self.march == "sphere":
            return kilonerf_sphere_march(*args, self.n_march_steps, dist=self.occ_dist)
        return kilonerf_march(*args)

    def budget_slots(self, mask: torch.Tensor):
        """The ``eval_budget`` live-first compaction: slot m of the budget
        holds ray ``ray_id[m]``'s sample ``j_in[m]`` where ``valid[m]``.
        Every march front-compacts each ray, so the ray-major live-first
        order is the rays' live prefixes laid end to end at the exclusive
        cumsum of their live counts. Returns (offset [n], sel [M], valid [M])."""
        n, k = mask.shape
        M = self.eval_budget
        c = mask.sum(-1, dtype=torch.int64)
        offset = torch.cumsum(c, 0) - c
        starts = torch.zeros(M + 1, dtype=torch.int64, device=mask.device).index_add_(
            0, offset.clamp(max=M), torch.ones_like(offset))
        ray_id = (torch.cumsum(starts[:M], 0) - 1).clamp(0, n - 1)  # ties resolve to the last ray
        j_in = torch.arange(M, device=mask.device) - offset[ray_id]
        valid = (j_in >= 0) & (j_in < c[ray_id])
        sel = torch.where(valid, ray_id * k + j_in.clamp(min=0), 0)
        return offset, sel, valid

    def _render_fast(self, batch, viewdirs) -> Dict[str, torch.Tensor]:
        """ESS + keep-K eval: march, evaluate the live samples through the
        gather dispatch, composite with the fixed candidate step."""
        rays_o, rays_d = batch["rays_o"], batch["rays_d"]
        z_keep, mask, dt = self.march_samples(batch)
        n, k = z_keep.shape
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_keep[..., None]
        net_idx, local = assign_networks(pts.reshape(n * k, 3), self.domain_lo, self.domain_hi, self.resolution)
        net_idx = torch.where(mask.reshape(-1), net_idx, -1)
        dirs_flat = viewdirs[:, None].expand(n, k, 3).reshape(n * k, 3)
        M = self.eval_budget
        if 0 < M < n * k:
            offset, sel, valid = self.budget_slots(mask)
            rgb_c, sigma_c = self.mlp(local[sel], dirs_flat[sel], torch.where(valid, net_idx[sel], -1),
                                      gather_dispatch=True)
            # un-compact: slot (i, j) sits at offset[i] + j; rays past the budget render empty
            pos = offset[:, None] + torch.arange(k, device=mask.device)[None, :]
            ok = (mask & (pos < M)).reshape(-1)
            o4 = torch.cat([rgb_c, sigma_c[:, None]], -1)[pos.clamp(0, M - 1).reshape(-1)]
            raw_rgb = torch.where(ok[:, None], o4[:, :3], 0.0)
            raw_sigma = torch.where(ok, o4[:, 3], -1e3)
        else:
            raw_rgb, raw_sigma = self.mlp(local, dirs_flat, net_idx, gather_dispatch=True)
        rgb = torch.sigmoid(raw_rgb.reshape(n, k, 3))
        sigma = torch.where(mask, F.relu(raw_sigma.reshape(n, k)), 0.0)
        alpha = 1.0 - torch.exp(-sigma * (dt * torch.linalg.norm(rays_d, dim=-1, keepdim=True)))
        trans = torch.cat([torch.ones_like(alpha[..., :1]), torch.cumprod(1.0 - alpha[..., :-1] + 1e-10, -1)], -1)
        weights = alpha * trans
        rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
        acc = weights.sum(-1)
        depth = torch.sum(weights * z_keep, dim=-1)
        disp = 1.0 / torch.clamp(depth / torch.clamp(acc, min=1e-10), min=1e-10)
        if self.white_bkgd:
            rgb_map = rgb_map + (1.0 - acc[..., None])
        return {"rgb": rgb_map, "disp": disp, "acc": acc, "depth": depth}

    # -- losses -------------------------------------------------------------
    def loss(self, outputs, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        mse = img2mse(outputs["rgb"], batch["target"])
        return mse, {"loss": mse, "mse": mse, "psnr": mse2psnr(mse)}

    def param_loss(self) -> torch.Tensor:
        """L2 on the view-dependent (colour-branch) weights."""
        sq = self.mlp.color_hidden_w.square().sum() + self.mlp.rgb_w.square().sum()
        return self.view_dep_reg * reduce_from(sq, model_group(self.mlp))

    def param_spec(self, name: str):
        """The expert stacks ``mlp.*_w`` / ``mlp.*_b`` [n_nets, ...] on the model axis."""
        return (MODEL_AXIS,) if name.startswith("mlp.") else None


@NETWORKS.register
class StudentNerfNetwork(nn.Module):
    """Distillation student: the multi-network field fitted to teacher point
    samples (the teacher lives in the dataset, which precomputes targets)."""

    def __init__(
        self,
        resolution: Sequence[int] = (16, 16, 16),
        domain_min: Sequence[float] = (-1.0, -1.0, -1.0),
        domain_max: Sequence[float] = (1.0, 1.0, 1.0),
        hidden: int = 32,
        n_hidden_layers: int = 2,
        multires: int = 10,
        multires_dirs: int = 4,
        capacity_factor: float = 4.0,
        sigma_loss_weight: float = 0.1,
    ):
        super().__init__()
        self.resolution = tuple(int(r) for r in resolution)
        self.domain_min, self.domain_max = tuple(domain_min), tuple(domain_max)
        # the domain on the network's device, so no step or chunk copies it from the host
        self.register_buffer("domain_lo", torch.tensor(self.domain_min, dtype=torch.float32), persistent=False)
        self.register_buffer("domain_hi", torch.tensor(self.domain_max, dtype=torch.float32), persistent=False)
        self.sigma_loss_weight = sigma_loss_weight
        self.mlp = MultiNetworkMLP(int(np.prod(self.resolution)), hidden, n_hidden_layers, multires, multires_dirs,
                                   capacity_factor)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.mlp.reset_parameters(generator)

    def forward(self, batch, generator=None, train: bool = False) -> Dict[str, torch.Tensor]:
        net_idx, local = assign_networks(batch["pts"], self.domain_lo, self.domain_hi, self.resolution)
        raw_rgb, raw_sigma = self.mlp(local, batch["dirs"], net_idx, rows=getattr(generator, "rows", None))
        return {"rgb": torch.sigmoid(raw_rgb), "sigma": F.relu(raw_sigma)}

    def loss(self, outputs, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        rgb_mse = img2mse(outputs["rgb"], batch["target_rgb"])
        sigma_mse = torch.mean((outputs["sigma"] - batch["target_sigma"]) ** 2)
        loss = rgb_mse + self.sigma_loss_weight * sigma_mse
        return loss, {"loss": loss, "rgb_mse": rgb_mse, "sigma_mse": sigma_mse}


def build_occupancy_grid(density_fn, domain_min: Sequence[float], domain_max: Sequence[float],
                         res: Sequence[int] = (256, 256, 256), subsamples: int = 3, threshold: float = 10.0,
                         device="cuda") -> np.ndarray:
    """Dense teacher-density sweep -> bool occupancy grid [res]: per voxel,
    ``subsamples``^3 lattice points at cell-fraction centres, any of them
    over ``threshold``. ``density_fn`` maps world points [M, 3] (a tensor on
    ``device``) to densities [M]; one call per plane of the fine lattice.
    The points are the JAX version's f32 values, made once on the device."""
    dev = resolve_device(device)
    res = tuple(int(r) for r in res)
    s = int(subsamples)
    fine = [r * s for r in res]
    dmin = np.asarray(domain_min, np.float32)
    span = np.asarray(domain_max, np.float32) - dmin
    xs = [(np.arange(f, dtype=np.float32) + 0.5) / f for f in fine]
    yy, zz = np.meshgrid(xs[1], xs[2], indexing="ij")
    plane = torch.from_numpy(np.stack([np.zeros_like(yy), yy, zz], -1).reshape(-1, 3)).to(dev)
    world_yz = plane * torch.from_numpy(span).to(dev) + torch.from_numpy(dmin).to(dev)
    world_x = torch.from_numpy(dmin[0] + xs[0] * span[0]).to(dev)  # [fine_x]
    occ = torch.zeros(res, dtype=torch.bool, device=dev)
    with torch.no_grad():
        for ix in range(fine[0]):
            world = world_yz.clone()
            world[:, 0] = world_x[ix]
            hit = density_fn(world).reshape(fine[1], fine[2]) > threshold
            occ[ix // s] |= hit.reshape(res[1], s, res[2], s).any(3).any(1)
    return occ.cpu().numpy()
