"""Volume rendering integrators — port of
``xrnerf_tpu/models/renders/volume.py``.

- ``volume_render``: 1e10 far pad, ray-norm scaled dists, density noise,
  ``1 - alpha + 1e-10`` in the exclusive cumprod, clamped disp and
  white-background compositing. The JAX version's ``rgb_padding`` /
  ``density_activation`` / ``density_bias`` options have no caller there
  and are left out.
- ``mip_volume_render``: Mip-NeRF's compositing over interval edges
  (padded sigmoid colour, ``softplus(raw + density_bias)``, transmittance
  from an exclusive cumsum of ``density * delta``, distance clamped to the
  sampled range)."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F


class _PositiveCumprod(torch.autograd.Function):
    """``torch.cumprod`` over the last dim for inputs > 0. Its backward is
    torch's own for inputs without zeros, ``reversed_cumsum(g * out) / x``,
    minus torch's check for zeros, a device-to-host sync per call."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return (g * out).flip(-1).cumsum(-1).flip(-1) / x


def exclusive_cumprod(x: torch.Tensor) -> torch.Tensor:
    """cumprod shifted right by one with leading 1 (transmittance); ``x``
    must be > 0, as ``1 - alpha + 1e-10`` is."""
    return torch.cat([torch.ones_like(x[..., :1]), _PositiveCumprod.apply(x[..., :-1])], dim=-1)


def volume_render(
    raw_rgb: torch.Tensor,  # [N, S, 3] pre-activation
    raw_sigma: torch.Tensor,  # [N, S] pre-activation
    z_vals: torch.Tensor,  # [N, S]
    rays_d: torch.Tensor,  # [N, 3]
    generator: Optional[torch.Generator] = None,
    raw_noise_std: float = 0.0,
    white_bkgd: bool = False,
) -> Dict[str, torch.Tensor]:
    """Composite raw field outputs into rgb/disp/acc/depth/weights maps."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)

    rgb = torch.sigmoid(raw_rgb)
    sigma = raw_sigma
    if raw_noise_std > 0.0 and generator is not None:
        noise = torch.randn(sigma.shape, generator=generator, dtype=sigma.dtype, device=sigma.device)
        sigma = sigma + raw_noise_std * noise

    alpha = 1.0 - torch.exp(-F.relu(sigma) * dists)
    weights = alpha * exclusive_cumprod(1.0 - alpha + 1e-10)  # [N, S]

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.clamp(depth_map / torch.clamp(acc_map, min=1e-10), min=1e-10)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])

    return {
        "rgb": rgb_map,
        "disp": disp_map,
        "acc": acc_map,
        "depth": depth_map,
        "weights": weights,
        "alpha": alpha,
    }


def mip_volume_render(
    raw_rgb: torch.Tensor,  # [N, S, 3] pre-activation
    raw_sigma: torch.Tensor,  # [N, S] pre-activation
    t_vals: torch.Tensor,  # [N, S+1] interval edges
    rays_d: torch.Tensor,  # [N, 3]
    white_bkgd: bool = False,
    rgb_padding: float = 0.001,
    density_bias: float = -1.0,
) -> Dict[str, torch.Tensor]:
    """Composite Mip-NeRF's raw outputs into rgb/acc/depth/distance/weights."""
    t_mids = 0.5 * (t_vals[..., :-1] + t_vals[..., 1:])
    t_dists = t_vals[..., 1:] - t_vals[..., :-1]
    delta = t_dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)

    rgb = torch.sigmoid(raw_rgb) * (1.0 + 2.0 * rgb_padding) - rgb_padding
    density = F.softplus(raw_sigma + density_bias)

    density_delta = density * delta
    alpha = 1.0 - torch.exp(-density_delta)
    trans = torch.exp(-torch.cat(
        [torch.zeros_like(density_delta[..., :1]), torch.cumsum(density_delta[..., :-1], dim=-1)], dim=-1
    ))
    weights = alpha * trans

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    acc_map = torch.sum(weights, dim=-1)
    depth_map = torch.sum(weights * t_mids, dim=-1)
    # distance clamped to the sampled range (mip convention)
    distance = torch.nan_to_num(depth_map / torch.clamp(acc_map, min=1e-10), nan=math.inf)
    distance = torch.clamp(distance, t_vals[..., 0], t_vals[..., -1])
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return {"rgb": rgb_map, "acc": acc_map, "depth": depth_map, "distance": distance, "weights": weights}
