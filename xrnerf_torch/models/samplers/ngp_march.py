"""NGP ray marching with occupancy skipping — port of
``xrnerf_tpu/models/samplers/ngp_march.py``: the static-shape two-pass
masked march.

  pass 1 (cheap):   per ray, ``n_candidates`` steps through the AABB; one
                    bitfield lookup each marks the live samples.
  compact (static): a stable key-sort per ray moves live samples to the
                    front; the first ``n_keep`` survive.
  pass 2 (hot):     the field evaluates only [N, n_keep] positions.

Every shape is static and nothing is copied to the host, so the march does
not stall the card.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ...parallel.mesh import draw
from ..renders.volume import exclusive_cumprod
from .occupancy import GRID_RES, OccupancyGrid, occupied_at

# NGP step size: sqrt(3)/1024 covers the unit cube in <= 1024 steps
SQRT3 = 1.7320508075688772


class MarchResult(NamedTuple):
    pts: torch.Tensor  # [N, K, 3] sample positions (unit-cube coords)
    dirs: torch.Tensor  # [N, 3] ray directions (normalized)
    z_vals: torch.Tensor  # [N, K] distances along the ray
    dt: torch.Tensor  # [N, K] step sizes
    mask: torch.Tensor  # [N, K] live-sample mask


def aabb_intersect(
    rays_o: torch.Tensor, rays_d: torch.Tensor, aabb_min: float = 0.0, aabb_max: float = 1.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab test returning (t_near, t_far), clamped to t >= 0."""
    inv = 1.0 / torch.where(rays_d.abs() > 1e-10, rays_d, 1e-10)
    t0 = (aabb_min - rays_o) * inv
    t1 = (aabb_max - rays_o) * inv
    t_near = torch.minimum(t0, t1).amax(dim=-1).clamp(min=0.0)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    return t_near, torch.maximum(t_far, t_near)


def _cascade_of(pos: torch.Tensor, n_cascades: int) -> torch.Tensor:
    """NGP mip selection: smallest cascade whose box contains the point."""
    d = (pos - 0.5).abs().amax(dim=-1)
    casc = torch.ceil(torch.log2((2.0 * d).clamp(min=1e-10)))
    return casc.clamp(0, n_cascades - 1).long()


def march_rays(
    generator: Optional[torch.Generator],
    rays_o: torch.Tensor,  # [N, 3] in grid (unit-cube) coords
    rays_d: torch.Tensor,  # [N, 3]
    grid: OccupancyGrid,
    n_candidates: int = 512,
    n_keep: int = 64,
    cone_angle: float = 0.0,
    res: int = GRID_RES,
) -> MarchResult:
    """Two-pass masked march (see module docstring).

    Candidate schedule: with ``cone_angle == 0`` (single-cascade scenes),
    ``n_candidates`` stratified steps across [t_near, t_far]. With
    ``cone_angle > 0`` (multi-cascade / unbounded), the NGP stepping rule
    ``dt = clamp(t * cone_angle, dt_min, dt_max)`` with
    dt_min = sqrt(3)/n_candidates and dt_max = dt_min * 2^(C-1), realised as
    the closed-form linear -> exponential -> capped-linear lattice.
    ``generator`` jitters the candidates; ``None`` marches deterministically.
    """
    dirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True).clamp(min=1e-10)
    bound = 0.5 * 2.0 ** (grid.n_cascades - 1)
    t_near, t_far = aabb_intersect(rays_o, dirs, 0.5 - bound, 0.5 + bound)

    n = rays_o.shape[0]
    S = n_candidates
    kw = dict(dtype=rays_o.dtype, device=rays_o.device)
    if cone_angle > 0.0:
        dt_min = SQRT3 / S
        dt_max = dt_min * float(2 ** (grid.n_cascades - 1))
        log1p_c = math.log1p(cone_angle)
        # per-ray start jitter
        i = torch.arange(S, **kw)[None, :]
        if generator is not None:
            i = i + draw(torch.rand, (n, 1), generator, **kw)
        tn = t_near[:, None]
        ta = tn.clamp(min=dt_min / cone_angle)  # end of dt_min regime
        tb = dt_max / cone_angle  # start of dt_max regime
        ia = ((ta - tn) / dt_min).clamp(min=0.0)
        ib = ia + torch.log((tb / ta).clamp(min=1.0)) / log1p_c
        t_lin = tn + dt_min * i
        t_exp = ta * torch.exp(log1p_c * (i - ia))
        t_cap = tb + dt_max * (i - ib)
        z = torch.where(i <= ia, t_lin, torch.where(i <= ib, t_exp, t_cap))
        dt = (z * cone_angle).clamp(dt_min, dt_max)  # [N, S]
    else:
        # stratified candidate steps; jittered so grid aliasing decorrelates
        u = torch.linspace(0.0, 1.0, S, **kw)
        if generator is not None:
            u = u + draw(torch.rand, (n, S), generator, **kw) / S
        else:
            u = u.expand(n, S)
        span = (t_far - t_near)[:, None]
        z = t_near[:, None] + u * span  # [N, S]
        dt = (span / S).expand(n, S)

    pts = rays_o[:, None, :] + dirs[:, None, :] * z[..., None]  # [N, S, 3]
    casc = _cascade_of(pts, grid.n_cascades)
    live = occupied_at(grid, pts, casc, res) & (z < t_far[:, None])

    # static compaction: stable sort by (dead, z) and keep the first n_keep
    sort_key = torch.where(live, z, math.inf)
    order = torch.argsort(sort_key, dim=-1, stable=True)[:, :n_keep]  # [N, K]
    mask = torch.gather(live, -1, order)
    z_keep = torch.where(mask, torch.gather(z, -1, order), t_far[:, None])  # park dead samples at far
    dt_keep = torch.gather(dt, -1, order)
    pts_keep = rays_o[:, None, :] + dirs[:, None, :] * z_keep[..., None]
    pts_keep = pts_keep.clamp(0.5 - bound, 0.5 + bound)
    return MarchResult(pts=pts_keep, dirs=dirs, z_vals=z_keep, dt=dt_keep, mask=mask)


def composite_masked(
    raw_rgb: torch.Tensor,  # [N, K, 3] pre-activation
    raw_sigma: torch.Tensor,  # [N, K] pre-activation
    march: MarchResult,
    white_bkgd: bool = True,
    density_activation: str = "exp",
) -> Dict[str, torch.Tensor]:
    """Alpha compositing over masked marched samples (sigmoid rgb, exp or
    relu density, residual-transmittance background blend)."""
    rgb = torch.sigmoid(raw_rgb)
    if density_activation == "exp":
        sigma = torch.exp(raw_sigma.clamp(-15.0, 15.0))
    elif density_activation == "relu":
        sigma = F.relu(raw_sigma)
    else:
        raise ValueError(density_activation)
    sigma = torch.where(march.mask, sigma, 0.0)

    alpha = 1.0 - torch.exp(-sigma * march.dt)
    weights = alpha * exclusive_cumprod(1.0 - alpha + 1e-10)
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    acc = torch.sum(weights, dim=-1)
    depth = torch.sum(weights * march.z_vals, dim=-1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc[..., None])
    return {"rgb": rgb_map, "acc": acc, "depth": depth, "weights": weights}
