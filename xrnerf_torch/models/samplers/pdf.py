"""Hierarchical importance sampling (inverse CDF over coarse weights) —
port of ``xrnerf_tpu/models/samplers/pdf.py``.

The JAX version brackets each ``u`` with a dense ``[N, B, S]`` masked
min/max (a TPU workaround for serial binary search). On the card that mask
alone is ~0.5 GB at chunk 16384, so the port uses ``torch.searchsorted``
(side right), which selects the same pair: ``below`` is the last bin whose
cdf is <= u, ``above`` the first whose cdf is > u, clamped to the last bin.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...parallel.mesh import draw


def sample_pdf(
    bins: torch.Tensor,  # [N, B] z-val midpoints
    weights: torch.Tensor,  # [N, B-1]
    num_samples: int,
    det: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Draw [N, num_samples] z-vals distributed as the weight histogram."""
    weights = weights.detach() + 1e-5
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [N, B]

    shape = cdf.shape[:-1] + (num_samples,)
    if det or generator is None:
        u = torch.linspace(0.0, 1.0, num_samples, dtype=bins.dtype, device=bins.device)
        u = u.expand(shape).contiguous()
    else:
        u = draw(torch.rand, shape, generator, dtype=bins.dtype, device=bins.device)

    last = cdf.shape[-1] - 1
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=last)

    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return (bins_below + t * (bins_above - bins_below)).detach()
