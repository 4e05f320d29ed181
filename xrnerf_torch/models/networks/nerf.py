"""Vanilla NeRF network: coarse -> importance -> fine hierarchical rendering.

Port of ``xrnerf_tpu/models/networks/nerf.py``: coarse MLP -> volume render
-> ``sample_pdf`` importance resampling -> sort -> fine MLP -> render; MSE
loss on fine + coarse rgb. Randomness (stratified jitter, pdf draws,
density noise) comes from one ``torch.Generator`` passed to ``forward``;
eval (``train=False``) is deterministic and runs under
``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.nerf_posenc import nerf_posenc
from ...registry import NETWORKS
from ...utils.metrics import img2mse, mse2psnr
from ...utils.spans import span
from ..embedders.posenc import posenc, posenc_channels
from ..fields.nerf_mlp import NerfMLP
from ..renders.volume import volume_render
from ..samplers.pdf import sample_pdf
from ..samplers.stratified import sample_along_rays, z_to_pts


@NETWORKS.register
class NerfNetwork(nn.Module):
    """``dtype``: the compute dtype of both MLPs (the JAX field
    ``xrnerf_tpu/models/networks/nerf.py:45``, passed on at ``:70`` and
    ``:78``; ``fields/nerf_mlp.py:NerfMLP``). ``fused=True`` ignores it."""

    def __init__(
        self,
        n_samples: int = 64,
        n_importance: int = 128,
        multires: int = 10,
        multires_dirs: int = 4,
        netdepth: int = 8,
        netwidth: int = 256,
        use_viewdirs: bool = True,
        white_bkgd: bool = True,
        raw_noise_std: float = 0.0,
        lindisp: bool = False,
        perturb: bool = True,
        coarse_loss_weight: float = 1.0,
        fused: bool = False,
        dtype=torch.float32,
    ):
        super().__init__()
        self.n_samples, self.n_importance = n_samples, n_importance
        self.multires, self.multires_dirs = multires, multires_dirs
        self.use_viewdirs = use_viewdirs
        self.white_bkgd = white_bkgd
        self.raw_noise_std = raw_noise_std
        self.lindisp = lindisp
        self.perturb = perturb
        self.coarse_loss_weight = coarse_loss_weight
        # Both MLPs go through the fused kernel (bf16 tensor cores, f32
        # accumulate; ops/fused_nerf_mlp.py). Same parameters either way.
        self.fused = fused
        mlp_kw = dict(
            in_ch=posenc_channels(3, multires),
            in_ch_views=posenc_channels(3, multires_dirs) if use_viewdirs else 0,
            netdepth=netdepth,
            netwidth=netwidth,
            use_viewdirs=use_viewdirs,
            fused=fused,
            dtype=dtype,
        )
        self.mlp_coarse = NerfMLP(**mlp_kw)
        if n_importance > 0:
            self.mlp_fine = NerfMLP(**mlp_kw)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax ``Dense`` initialisation (truncated lecun-normal, zero bias)."""
        for mlp in self.children():
            mlp.reset_parameters(generator)

    def _eval_mlp(self, mlp: NerfMLP, pts: torch.Tensor, viewdirs: torch.Tensor):
        """Encode + run MLP over [N, S, 3] pts with per-ray viewdirs [N, 3]."""
        n, s, _ = pts.shape
        with span("xrnerf_torch.nerf.encode"):
            if self.fused:
                # posenc_fast of both inputs, one kernel on the card (ops/nerf_posenc.py);
                # the fused MLP consumes them in bf16, where its ~1e-3 error is invisible
                pts_enc, views_enc = nerf_posenc(pts, viewdirs, self.multires, self.multires_dirs)
            else:
                pts_enc = posenc(pts.reshape(n * s, 3), self.multires)
                views_enc = None
                if self.use_viewdirs:
                    # each ray's encoding for its s samples; expand + reshape, since
                    # repeat_interleave sizes its output with a device-to-host sync
                    views_enc = posenc(viewdirs, self.multires_dirs)
                    views_enc = views_enc[:, None].expand(n, s, views_enc.shape[-1]).reshape(n * s, -1)
        with span("xrnerf_torch.nerf.mlp"):
            rgb, sigma = mlp(pts_enc, views_enc)
        return rgb.reshape(n, s, 3), sigma.reshape(n, s)

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
        perturb = self.perturb and train
        with span("xrnerf_torch.nerf.sample"):
            viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
            z_vals = sample_along_rays(
                near, far, self.n_samples, lindisp=self.lindisp, perturb=perturb,
                generator=generator if perturb else None,
            )
            pts = z_to_pts(rays_o, rays_d, z_vals)
        rgb_c, sigma_c = self._eval_mlp(self.mlp_coarse, pts, viewdirs)
        noise = self.raw_noise_std if train else 0.0
        with span("xrnerf_torch.nerf.composite"):
            ret_c = volume_render(
                rgb_c, sigma_c, z_vals, rays_d,
                generator=generator if train else None,
                raw_noise_std=noise, white_bkgd=self.white_bkgd,
            )
        out = {
            "coarse_rgb": ret_c["rgb"],
            "coarse_disp": ret_c["disp"],
            "coarse_acc": ret_c["acc"],
        }
        if self.n_importance > 0:
            with span("xrnerf_torch.nerf.sample"):
                z_mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
                z_samples = sample_pdf(
                    z_mids, ret_c["weights"][..., 1:-1], self.n_importance,
                    det=not perturb, generator=generator if perturb else None,
                )
                z_all, _ = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1)
                pts_f = z_to_pts(rays_o, rays_d, z_all)
            rgb_f, sigma_f = self._eval_mlp(self.mlp_fine, pts_f, viewdirs)
            with span("xrnerf_torch.nerf.composite"):
                ret = volume_render(
                    rgb_f, sigma_f, z_all, rays_d,
                    generator=generator if train else None,
                    raw_noise_std=noise, white_bkgd=self.white_bkgd,
                )
        else:
            ret = ret_c
        out.update(rgb=ret["rgb"], disp=ret["disp"], acc=ret["acc"], depth=ret["depth"])
        return out

    def eval_field(
        self, pts: torch.Tensor, viewdirs: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Point-wise field eval (fine MLP): [B,3],[B,3] -> (sigmoid rgb,
        relu sigma); the KiloNeRF distillation teacher."""
        mlp = self.mlp_fine if self.n_importance > 0 else self.mlp_coarse
        raw_rgb, raw_sigma = self._eval_mlp(mlp, pts[:, None, :], viewdirs)
        return torch.sigmoid(raw_rgb[:, 0]), F.relu(raw_sigma[:, 0])

    def loss(
        self, outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        target = batch["target"]
        mse = img2mse(outputs["rgb"], target)
        loss = mse
        log = {"mse": mse, "psnr": mse2psnr(mse)}
        if "coarse_rgb" in outputs and self.n_importance > 0:
            mse_c = img2mse(outputs["coarse_rgb"], target)
            loss = loss + self.coarse_loss_weight * mse_c
            log["coarse_mse"] = mse_c
        log["loss"] = loss
        return loss, log
