"""Stratified z-value sampling along rays — port of
``xrnerf_tpu/models/samplers/stratified.py``."""

from __future__ import annotations

from typing import Optional

import torch

from ...parallel.mesh import draw


def sample_along_rays(
    near: torch.Tensor,  # [N, 1]
    far: torch.Tensor,  # [N, 1]
    num_samples: int,
    lindisp: bool = False,
    perturb: bool = True,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Returns z_vals [N, num_samples]; jittered within strata when
    ``perturb`` and a ``generator`` is given."""
    t = torch.linspace(0.0, 1.0, num_samples, dtype=near.dtype, device=near.device)
    if lindisp:
        z = 1.0 / (1.0 / torch.clamp(near, min=1e-10) * (1.0 - t) + 1.0 / far * t)
    else:
        z = near * (1.0 - t) + far * t  # [N, S]
    if perturb and generator is not None:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], -1)
        lower = torch.cat([z[..., :1], mids], -1)
        u = draw(torch.rand, z.shape, generator, dtype=z.dtype, device=z.device)
        z = lower + (upper - lower) * u
    return z


def z_to_pts(rays_o: torch.Tensor, rays_d: torch.Tensor, z_vals: torch.Tensor) -> torch.Tensor:
    """[N,3], [N,3], [N,S] -> pts [N,S,3]."""
    return rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
