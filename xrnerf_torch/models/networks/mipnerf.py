"""Mip-NeRF network — port of ``xrnerf_tpu/models/networks/mipnerf.py``:
``num_levels`` passes of sample (level 0) or resample (later levels) →
conical-frustum Gaussians → IPE → ONE shared ``NerfMLP`` → mip compositing;
the ``lossmult``-weighted multiscale loss with ``coarse_loss_mult`` on the
earlier levels.

The JAX network builds its MLP without ``fused``, so it runs as plain f32
products there; here it is the unfused f32 ``NerfMLP`` (``nn.Linear``),
named ``mlp`` so the flax tree ``mlp/pts_0 …`` maps one to one through
``utils/weights.py``. Randomness (level-0 jitter, resampling draws, density
noise) comes from the ``torch.Generator`` passed to ``forward``;
``train=True`` without one is the deterministic training path (autograd on,
no jitter), as ``rng=None`` is in JAX. Eval (``train=False``) runs under
``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from ...parallel.mesh import draw
from ...registry import NETWORKS
from ...utils.metrics import mse2psnr
from ..embedders.mip import integrated_pos_enc, pos_enc, resample_along_rays, sample_along_rays_mip
from ..fields.nerf_mlp import NerfMLP
from ..renders.volume import mip_volume_render


@NETWORKS.register
class MipNerfNetwork(nn.Module):
    def __init__(
        self,
        num_levels: int = 2,
        n_samples: int = 128,
        min_deg_point: int = 0,
        max_deg_point: int = 16,
        deg_view: int = 4,
        netdepth: int = 8,
        netwidth: int = 256,
        use_viewdirs: bool = True,
        white_bkgd: bool = True,
        lindisp: bool = False,
        ray_shape: str = "cone",
        stop_level_grad: bool = True,
        resample_padding: float = 0.01,
        rgb_padding: float = 0.001,
        density_bias: float = -1.0,
        density_noise: float = 0.0,
        coarse_loss_mult: float = 0.1,
    ):
        super().__init__()
        self.num_levels, self.n_samples = num_levels, n_samples
        self.min_deg_point, self.max_deg_point, self.deg_view = min_deg_point, max_deg_point, deg_view
        self.use_viewdirs = use_viewdirs
        self.white_bkgd, self.lindisp, self.ray_shape = white_bkgd, lindisp, ray_shape
        self.stop_level_grad, self.resample_padding = stop_level_grad, resample_padding
        self.rgb_padding, self.density_bias, self.density_noise = rgb_padding, density_bias, density_noise
        self.coarse_loss_mult = coarse_loss_mult
        # ONE MLP shared across levels (the difference from vanilla NeRF)
        self.mlp = NerfMLP(
            in_ch=6 * (max_deg_point - min_deg_point),
            in_ch_views=3 + 6 * deg_view if use_viewdirs else 0,
            netdepth=netdepth,
            netwidth=netwidth,
            use_viewdirs=use_viewdirs,
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax ``Dense`` initialisation (truncated lecun-normal, zero bias)."""
        self.mlp.reset_parameters(generator)

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
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        views = pos_enc(viewdirs, 0, self.deg_view) if self.use_viewdirs else None

        levels: List[Dict[str, torch.Tensor]] = []
        t_vals, weights = None, None
        for lvl in range(self.num_levels):
            if lvl == 0:
                t_vals, (means, covs) = sample_along_rays_mip(
                    generator, rays_o, rays_d, radii, self.n_samples,
                    near, far, train, self.lindisp, self.ray_shape,
                )
            else:
                t_vals, (means, covs) = resample_along_rays(
                    generator, rays_o, rays_d, radii, t_vals, weights,
                    train, self.ray_shape, self.stop_level_grad, self.resample_padding,
                )
            n, s, _ = means.shape
            enc = integrated_pos_enc(
                (means.reshape(n * s, 3), covs.reshape(n * s, 3)), self.min_deg_point, self.max_deg_point
            )
            views_enc = None
            if views is not None:
                # each ray's encoding for its s samples; expand + reshape, since
                # repeat_interleave sizes its output with a device-to-host sync
                views_enc = views[:, None].expand(n, s, views.shape[-1]).reshape(n * s, -1)
            raw_rgb, raw_sigma = self.mlp(enc, views_enc)
            raw_sigma = raw_sigma.reshape(n, s)
            if train and self.density_noise > 0 and generator is not None:
                noise = draw(torch.randn, raw_sigma.shape, generator, dtype=raw_sigma.dtype, device=raw_sigma.device)
                raw_sigma = raw_sigma + self.density_noise * noise
            ret = mip_volume_render(
                raw_rgb.reshape(n, s, 3), raw_sigma, t_vals, rays_d,
                white_bkgd=self.white_bkgd, rgb_padding=self.rgb_padding, density_bias=self.density_bias,
            )
            weights = ret["weights"]
            levels.append(ret)

        out = {k: levels[-1][k] for k in ("rgb", "acc", "distance")}
        for i, lv in enumerate(levels[:-1]):
            out[f"level{i}_rgb"] = lv["rgb"]
        return out

    def loss(
        self, outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        target = batch["target"]
        lossmult = batch.get("lossmult")
        if lossmult is None:
            lossmult = torch.ones_like(target[..., :1])
        denom = torch.clamp(torch.sum(lossmult), min=1e-8)

        def masked_mse(pred):
            return torch.sum(lossmult * (pred - target) ** 2) / (denom * 3.0)

        mse_fine = masked_mse(outputs["rgb"])
        loss = mse_fine
        log = {"mse": mse_fine, "psnr": mse2psnr(mse_fine)}
        lvl = 0
        while f"level{lvl}_rgb" in outputs:
            mse_c = masked_mse(outputs[f"level{lvl}_rgb"])
            loss = loss + self.coarse_loss_mult * mse_c
            log[f"level{lvl}_mse"] = mse_c
            lvl += 1
        log["loss"] = loss
        return loss, log
