"""BungeeNeRF network — port of ``xrnerf_tpu/models/networks/bungeenerf.py``:
mip-style sampling and one blurred-weight resample (the port's
``embedders/mip.py``), IPE of the points and the plain encoding of the view
directions, the per-stage residual MLP, and stage-cumulative compositing
(``softplus(sigma - 1)`` summed over the unlocked stages, rgb their mean);
the loss keeps only rays with ``scale_code <= stage`` and adds the coarse
pass's with ``coarse_loss_mult``.

The curriculum ``stage`` is data: a 0-d tensor of the batch (default the
last stage), compared with ``torch.arange`` on its device, so the stage mask
costs no host sync and one network serves every stage. Randomness comes
from the ``torch.Generator`` passed to ``forward``; ``train=True`` without
one is the deterministic training path, as ``rng=None`` is in JAX. Eval
runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...registry import NETWORKS
from ...utils.metrics import mse2psnr
from ..embedders.mip import integrated_pos_enc, pos_enc, resample_along_rays, sample_along_rays_mip
from ..fields.bungee_mlp import BungeeNerfMLP


def _stage_composite(raw_rgb, raw_sigma, stage_mask, t_vals, rays_d, white_bkgd: bool) -> Dict[str, torch.Tensor]:
    """raw_rgb [N, S, stages, 3], raw_sigma [N, S, stages], stage_mask
    [stages] 0/1, t_vals [N, S+1]: sum the unlocked stages' contributions,
    then composite."""
    rgb = torch.sum(torch.sigmoid(raw_rgb) * stage_mask[None, None, :, None], dim=-2) / torch.clamp(
        torch.sum(stage_mask), min=1.0)
    sigma = torch.sum(F.softplus(raw_sigma - 1.0) * stage_mask[None, None, :], dim=-1)
    t_mids = 0.5 * (t_vals[..., :-1] + t_vals[..., 1:])
    delta = (t_vals[..., 1:] - t_vals[..., :-1]) * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    dd = sigma * delta
    alpha = 1.0 - torch.exp(-dd)
    trans = torch.exp(-torch.cat([torch.zeros_like(dd[..., :1]), torch.cumsum(dd[..., :-1], dim=-1)], dim=-1))
    weights = alpha * trans
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    acc = torch.sum(weights, dim=-1)
    depth = torch.sum(weights * t_mids, dim=-1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc[..., None])
    return {"rgb": rgb_map, "acc": acc, "depth": depth, "weights": weights}


@NETWORKS.register
class BungeeNerfNetwork(nn.Module):
    """``dtype``: the MLP's compute dtype (the JAX field
    ``xrnerf_tpu/models/networks/bungeenerf.py:83``, passed on at ``:87``;
    ``fields/bungee_mlp.py:BungeeNerfMLP``)."""

    def __init__(
        self,
        n_stages: int = 4,
        n_samples: int = 64,
        n_resample: int = 64,
        min_deg_point: int = 0,
        max_deg_point: int = 10,
        deg_view: int = 4,
        netwidth: int = 256,
        white_bkgd: bool = False,
        iters_per_stage: int = 50000,
        coarse_loss_mult: float = 1.0,
        dtype=torch.float32,
    ):
        super().__init__()
        self.n_stages, self.n_samples, self.n_resample = n_stages, n_samples, n_resample
        self.min_deg_point, self.max_deg_point, self.deg_view = min_deg_point, max_deg_point, deg_view
        self.white_bkgd, self.iters_per_stage, self.coarse_loss_mult = white_bkgd, iters_per_stage, coarse_loss_mult
        self.mlp = BungeeNerfMLP(
            in_ch=6 * (max_deg_point - min_deg_point), in_ch_views=3 + 6 * deg_view,
            n_stages=n_stages, netwidth=netwidth, dtype=dtype,
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax ``Dense`` initialisation (truncated lecun-normal, zero bias)."""
        self.mlp.reset_parameters(generator)

    def _stage(self, batch, like: torch.Tensor) -> torch.Tensor:
        stage = batch.get("stage")
        return torch.full((), self.n_stages - 1, device=like.device) if stage is None else stage

    def _run_level(self, t_vals, means_covs, views, stage_mask, rays_d):
        means, covs = means_covs
        n, s, _ = means.shape
        enc = integrated_pos_enc((means.reshape(n * s, 3), covs.reshape(n * s, 3)),
                                 self.min_deg_point, self.max_deg_point)
        # each ray's view encoding for its s samples; expand + reshape, since
        # repeat_interleave sizes its output with a device-to-host sync
        venc = views[:, None].expand(n, s, views.shape[-1]).reshape(n * s, -1)
        raw_rgb, raw_sigma = self.mlp(enc, venc)
        return _stage_composite(raw_rgb.reshape(n, s, self.n_stages, 3), raw_sigma.reshape(n, s, self.n_stages),
                                stage_mask, t_vals, rays_d, self.white_bkgd)

    def forward(
        self,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        train: bool = False,
    ) -> Dict[str, torch.Tensor]:
        if train:
            return self._forward(batch, generator, train=True)
        with torch.inference_mode():
            return self._forward(batch, None, train=False)

    def _forward(self, batch, generator, train: bool) -> Dict[str, torch.Tensor]:
        rays_o, rays_d = batch["rays_o"], batch["rays_d"]
        near, far = batch["near"], batch["far"]
        radii = batch.get("radii")
        if radii is None:
            radii = torch.full_like(near, 1e-3)
        stage = self._stage(batch, rays_o)
        stage_mask = (torch.arange(self.n_stages, device=rays_o.device) <= stage).to(torch.float32)
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        views = pos_enc(viewdirs, 0, self.deg_view)

        t_vals, mc = sample_along_rays_mip(generator, rays_o, rays_d, radii, self.n_samples, near, far, train, False)
        ret_c = self._run_level(t_vals, mc, views, stage_mask, rays_d)
        t2, mc2 = resample_along_rays(generator, rays_o, rays_d, radii, t_vals, ret_c["weights"], train)
        ret_f = self._run_level(t2, mc2, views, stage_mask, rays_d)
        return {"rgb": ret_f["rgb"], "acc": ret_f["acc"], "depth": ret_f["depth"], "coarse_rgb": ret_c["rgb"]}

    def loss(
        self, outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        target = batch["target"]
        stage = self._stage(batch, target)
        scale_code = batch.get("scale_code")
        if scale_code is None:
            scale_code = torch.zeros_like(target[..., :1])
        # train only rays whose scale is unlocked
        m = (scale_code[..., 0] <= stage).to(torch.float32)[..., None]
        denom = torch.clamp(torch.sum(m) * 3.0, min=1.0)

        def masked_mse(pred):
            return torch.sum(m * (pred - target) ** 2) / denom

        mse = masked_mse(outputs["rgb"])
        mse_c = masked_mse(outputs["coarse_rgb"])
        loss = mse + self.coarse_loss_mult * mse_c
        return loss, {"loss": loss, "mse": mse, "coarse_mse": mse_c, "psnr": mse2psnr(mse)}
