"""Instant-NGP network: occupancy-marched hash-grid rendering — port of
``xrnerf_tpu/models/networks/hashnerf.py``.

forward = ``march_rays`` -> (batch-level compaction to ``sample_budget``) ->
``NGPField`` -> ``composite_masked``; Huber loss x5 plus mse for PSNR; the
occupancy grid's lifecycle (``init_aux`` / ``update_aux``).

The JAX package threads the grid through its Trainer as an ``aux`` pytree.
Here the network holds it as two buffers (``grid_density``,
``grid_bitfield``), so ``state_dict`` carries it into checkpoints and
``load_from`` files and ``network(batch)`` marches through it
(:meth:`set_grid` replaces it).

``fused`` is the counterpart of ``NerfNetwork``'s field of that name: it
selects ``NGPField``'s fused parameter layout and kernels, which the JAX
package reaches only by building ``NGPField(use_pallas=True)`` directly.
Eval (``train=False``) is deterministic and runs under
``torch.inference_mode()``; ``train=True`` marches under the step's generator
and is differentiable down to the hash table, on the card through the
backward kernels of the two tiny MLPs and the row scatter-add, with no
device-to-host copy in the step.

Under a mesh (``parallel.mesh``) ``param_spec`` cuts the hash table's bucket
dimension over the model axis, as the JAX network's does. The sample budget
is a rule on the global batch: with a data-sharded step generator
(``rows``) the condition ``0 < M < n k`` counts the global n, and the first M
live samples in global (rank-major) order are kept; each rank learns from one
all-gather of the live counts how many of its own it keeps, and evaluates
``min(M, n_local k)`` rows (exact; up to D times the one-process field rows
when the budget binds).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ...parallel.mesh import MODEL_AXIS, rows_before
from ...registry import NETWORKS
from ...utils.metrics import huber, img2mse, mse2psnr
from ..fields.ngp_mlp import NGPField
from ..samplers.ngp_march import SQRT3, composite_masked, march_rays
from ..samplers.occupancy import (
    GridDraws,
    OccupancyGrid,
    create_grid,
    generate_grid_samples,
    mark_untrained_cells,
    splat_density,
    update_bitfield,
)


@NETWORKS.register
class HashNerfNetwork(nn.Module):
    # Trainer aux-state protocol: refresh the grid every 16 steps
    aux_interval = 16

    def __init__(
        self,
        # field
        n_levels: int = 16,
        n_features: int = 2,
        log2_table_size: int = 19,
        base_res: int = 16,
        max_res: int = 2048,
        hidden_dim: int = 64,
        geo_feat_dim: int = 15,
        # marching
        n_cascades: int = 1,
        grid_res: int = 128,
        n_candidates: int = 512,
        n_keep: int = 64,
        cone_angle: float = 0.0,  # 0 for single-cascade blender scenes; ~1/256 for multi-cascade
        white_bkgd: bool = True,
        # grid update
        grid_update_samples: int = 65536,
        density_threshold: float = 0.01,
        # Batch-level sample compaction: only the first `sample_budget`
        # samples, live ones sorted to the front, reach the field; overflowing
        # live samples are dropped. 0 disables.
        sample_budget: int = 0,
        loss_scale: float = 5.0,
        huber_delta: float = 0.1,
        hash_layout: str = "vertex",  # 'vertex' (tcnn-exact) | 'brick' (one row per point and level)
        n_lattices: int = 1,  # brick only: 2 = staggered dual lattice
        brick_blend: str = "mean",  # brick only: 'smooth' = face-bump cross-fade
        fused: bool = False,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.n_cascades, self.grid_res = n_cascades, grid_res
        self.n_candidates, self.n_keep, self.cone_angle = n_candidates, n_keep, cone_angle
        self.white_bkgd = white_bkgd
        self.grid_update_samples, self.density_threshold = grid_update_samples, density_threshold
        self.sample_budget = sample_budget
        self.loss_scale, self.huber_delta = loss_scale, huber_delta
        self.fused = fused
        self.field = NGPField(
            n_levels=n_levels, n_features=n_features, log2_table_size=log2_table_size,
            base_res=base_res, max_res=max_res, hidden_dim=hidden_dim, geo_feat_dim=geo_feat_dim,
            fused=fused, hash_layout=hash_layout, n_lattices=n_lattices, brick_blend=brick_blend, dtype=dtype,
        )
        grid = create_grid(n_cascades, grid_res)
        self.register_buffer("grid_density", grid.density)
        self.register_buffer("grid_bitfield", grid.bitfield)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's distributions: lecun-normal weights, zero biases, the
        table's uniform."""
        self.field.reset_parameters(generator)

    @property
    def grid(self) -> OccupancyGrid:
        return OccupancyGrid(self.grid_density, self.grid_bitfield)

    def set_grid(self, grid: OccupancyGrid) -> None:
        """Copy ``grid`` into the network's buffers."""
        with torch.no_grad():
            self.grid_density.copy_(grid.density)
            self.grid_bitfield.copy_(grid.bitfield)

    def budget_slots(self, live: torch.Tensor, rows=None) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """The ``sample_budget`` compaction of [n k] live flags: None when it
        does not bind, else (sel [W] the samples the field evaluates, slot
        [n k] each sample's row among them, W where it is dropped). Live
        samples go to the front (the stable sort keeps ray / z order) and the
        first M are kept. With ``rows`` (a sharded step) the rule is the
        global batch's: a rank keeps its live samples whose global rank (those
        of lower ranks first) is below M, W = min(M, n k)."""
        M, nk = self.sample_budget, live.shape[0]
        if not 0 < M < nk * (rows.size if rows is not None else 1):
            return None
        perm = torch.argsort((~live).to(torch.uint8), stable=True)
        W = min(M, nk)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(nk, device=perm.device)
        if rows is None:
            return perm[:W], inv.clamp(max=M)
        keep = (M - rows_before(live.sum(), rows)).clamp(min=0)
        return perm[:W], torch.where(inv < keep, inv, W)

    def param_spec(self, name: str):
        """The table's bucket dimension on the model axis: vertex [L, T, F]
        -> (None, model), brick [L, n_lat, tb, 8F] -> (None, None, model, None)."""
        if name.endswith("encoding.table"):
            return (None, MODEL_AXIS) if self.field.encoding.table.dim() == 3 else (None, None, MODEL_AXIS, None)
        return None

    def density(self, pts: torch.Tensor) -> torch.Tensor:
        """Post-activation density at [..., 3] grid-coord points (used for
        grid updates)."""
        raw_sigma, _ = self.field.density(pts)
        return torch.exp(raw_sigma.clamp(-15.0, 15.0))

    def forward(
        self,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        train: bool = False,
    ) -> Dict[str, torch.Tensor]:
        if train:
            return self._forward(batch, generator)
        with torch.inference_mode():
            return self._forward(batch, None)

    def _forward(self, batch, generator) -> Dict[str, torch.Tensor]:
        march = march_rays(
            generator, batch["rays_o"], batch["rays_d"], self.grid,
            n_candidates=self.n_candidates, n_keep=self.n_keep, cone_angle=self.cone_angle,
            res=self.grid_res,
        )
        n, k, _ = march.pts.shape
        # each ray's direction for its k samples; expand + reshape keeps the
        # shape static (repeat_interleave sizes its output with a host sync)
        dirs = march.dirs[:, None, :].expand(n, k, 3).reshape(n * k, 3)
        flat_pts = march.pts.reshape(n * k, 3)
        rows = getattr(generator, "rows", None)
        slots = self.budget_slots(march.mask.reshape(-1), rows)
        if slots is not None:
            # the field on the selected samples only; every sample reads its
            # slot's result, a dropped one the appended row
            sel, slot = slots
            rgb_c, sigma_c = self.field(flat_pts.index_select(0, sel), dirs.index_select(0, sel))
            raw_rgb = torch.cat([rgb_c, rgb_c.new_zeros((1, 3))]).index_select(0, slot)
            # dropped (overflow) samples get -1e4 -> exp-clip ~ 0 density
            raw_sigma = torch.cat([sigma_c, sigma_c.new_full((1,), -1e4)]).index_select(0, slot)
        else:
            raw_rgb, raw_sigma = self.field(flat_pts, dirs)
        ret = composite_masked(
            raw_rgb.reshape(n, k, 3), raw_sigma.reshape(n, k), march, white_bkgd=self.white_bkgd
        )
        ret["n_live_samples"] = march.mask.sum()
        return ret

    def loss(
        self, outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        target = batch["target"]
        loss = self.loss_scale * huber(outputs["rgb"], target, self.huber_delta)
        mse = img2mse(outputs["rgb"], target)
        log = {"loss": loss, "mse": mse, "psnr": mse2psnr(mse)}
        if "alpha" in batch:
            log["acc_err"] = img2mse(outputs["acc"][..., None], batch["alpha"])
        log["live_frac"] = outputs["n_live_samples"] / (outputs["acc"].shape[0] * self.n_keep)
        return loss, log

    # ------------------------------------------------------------------
    # Trainer aux-state protocol (occupancy grid lifecycle)
    # ------------------------------------------------------------------
    def init_aux(self, dataset=None) -> OccupancyGrid:
        """Fresh occupancy grid in the network's buffers, with cells outside
        every training-camera frustum marked untrained (density -1, never
        revived by updates)."""
        grid = create_grid(self.n_cascades, self.grid_res, device=self.grid_density.device)
        poses = getattr(dataset, "poses_ngp", None)
        if poses is not None:
            i_train = getattr(dataset, "i_train", None)
            if i_train is not None:
                poses = poses[i_train]
            grid = mark_untrained_cells(
                grid, poses, float(dataset.focal), int(dataset.H), int(dataset.W), res=self.grid_res
            )
        self.set_grid(grid)
        return self.grid

    @torch.no_grad()
    def update_aux(
        self, generator: Optional[torch.Generator] = None, draws: Optional[GridDraws] = None
    ) -> OccupancyGrid:
        """Density-grid refresh: half uniform, half occupancy-biased samples,
        max-splat with decay, new bitfield. The grid stores per-step optical
        thickness sigma * dt, so the 0.01 threshold is NGP's minimum optical
        thickness. ``draws`` supplies the random numbers instead of
        ``generator``."""
        n_total = self.grid_update_samples
        n_uniform = n_total // 2
        pos, cascade, cell_idx = generate_grid_samples(
            generator, self.grid, n_uniform, n_total - n_uniform, 0.0, res=self.grid_res, draws=draws
        )
        sigma = self.density(pos)
        dt = SQRT3 / self.n_candidates * torch.exp2(cascade.float())
        grid = splat_density(self.grid, cascade, cell_idx, sigma * dt, res=self.grid_res)
        self.set_grid(update_bitfield(grid, self.density_threshold, res=self.grid_res))
        return self.grid
