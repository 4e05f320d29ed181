"""Mip-NeRF math — port of ``xrnerf_tpu/models/embedders/mip.py``: conical
frustum (or cylinder) Gaussians along rays, integrated positional encoding
(IPE), the plain positional encoding of view directions, level-0 sampling
and the blurred-weight resampling of later levels.

``sorted_piecewise_constant_pdf`` brackets each ``u`` with
``torch.searchsorted`` where the JAX version takes a max / min over a dense
``[N, B+1, S]`` mask (at ``eval_chunk`` 16384 and 129 edges each of its
``where`` s is ~1.1 GB). For a nondecreasing cdf that starts at 0 and
``u < 1`` the two pick the same pair of edges: the last with ``cdf <= u``
and the first with ``cdf > u`` (the last edge if there is none).

Randomness comes from a ``torch.Generator``; ``None`` means the
deterministic draw, as ``rng=None`` does in JAX.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ...parallel.mesh import draw

_F32_EPS = float(torch.finfo(torch.float32).eps)


def lift_gaussian(d, t_mean, t_var, r_var, diag: bool = True):
    """Project (t_mean, t_var, r_var) along rays ``d`` into 3D (mean, cov)."""
    mean = d[..., None, :] * t_mean[..., None]
    d_mag_sq = torch.clamp(torch.sum(d**2, dim=-1, keepdim=True), min=1e-10)
    if diag:
        d_outer_diag = d**2
        null_outer_diag = 1.0 - d_outer_diag / d_mag_sq
        t_cov_diag = t_var[..., None] * d_outer_diag[..., None, :]
        xy_cov_diag = r_var[..., None] * null_outer_diag[..., None, :]
        return mean, t_cov_diag + xy_cov_diag
    d_outer = d[..., :, None] * d[..., None, :]
    eye = torch.eye(d.shape[-1], dtype=d.dtype, device=d.device)
    null_outer = eye - d[..., :, None] * (d / d_mag_sq)[..., None, :]
    t_cov = t_var[..., None, None] * d_outer[..., None, :, :]
    xy_cov = r_var[..., None, None] * null_outer[..., None, :, :]
    return mean, t_cov + xy_cov


def conical_frustum_to_gaussian(d, t0, t1, base_radius, diag=True, stable=True):
    """Gaussian approximating a conical frustum [t0, t1] with base radius."""
    if stable:
        mu = (t0 + t1) / 2
        hw = (t1 - t0) / 2
        t_mean = mu + (2 * mu * hw**2) / (3 * mu**2 + hw**2)
        t_var = (hw**2) / 3 - (4 / 15) * ((hw**4 * (12 * mu**2 - hw**2)) / (3 * mu**2 + hw**2) ** 2)
        r_var = base_radius**2 * (
            (mu**2) / 4 + (5 / 12) * hw**2 - (4 / 15) * (hw**4) / (3 * mu**2 + hw**2)
        )
    else:
        t_mean = (3 * (t1**4 - t0**4)) / (4 * (t1**3 - t0**3))
        r_var = base_radius**2 * (3 / 20 * (t1**5 - t0**5) / (t1**3 - t0**3))
        t_mosq = 3 / 5 * (t1**5 - t0**5) / (t1**3 - t0**3)
        t_var = t_mosq - t_mean**2
    return lift_gaussian(d, t_mean, t_var, r_var, diag)


def cylinder_to_gaussian(d, t0, t1, radius, diag=True):
    t_mean = (t0 + t1) / 2
    r_var = radius**2 / 4
    t_var = (t1 - t0) ** 2 / 12
    return lift_gaussian(d, t_mean, t_var, r_var, diag)


def cast_rays(t_vals, origins, directions, radii, ray_shape: str = "cone", diag=True):
    """t_vals [N, S+1] edges -> (means, covs) each [N, S, 3] (covs [N, S,
    3, 3] with ``diag=False``)."""
    t0 = t_vals[..., :-1]
    t1 = t_vals[..., 1:]
    if ray_shape == "cone":
        gaussian_fn = conical_frustum_to_gaussian
    elif ray_shape == "cylinder":
        gaussian_fn = cylinder_to_gaussian
    else:
        raise ValueError(ray_shape)
    means, covs = gaussian_fn(directions, t0, t1, radii, diag)
    return means + origins[..., None, :], covs


def expected_sin(x, x_var):
    """E[sin(z)], z ~ N(x, x_var), and its variance."""
    y = torch.exp(-0.5 * x_var) * torch.sin(x)
    y_var = torch.clamp(0.5 * (1 - torch.exp(-2 * x_var) * torch.cos(2 * x)) - y**2, min=0)
    return y, y_var


def _scales(min_deg: int, max_deg: int, like: torch.Tensor) -> torch.Tensor:
    return 2.0 ** torch.arange(min_deg, max_deg, dtype=like.dtype, device=like.device)


def integrated_pos_enc(means_covs, min_deg: int, max_deg: int, diag: bool = True):
    """IPE over (mean, cov) Gaussians -> [..., 2*3*(max_deg-min_deg)]."""
    means, covs = means_covs
    scales = _scales(min_deg, max_deg, means)
    if diag:
        y = (means[..., None, :] * scales[:, None]).reshape(*means.shape[:-1], -1)
        y_var = (covs[..., None, :] * scales[:, None] ** 2).reshape(*means.shape[:-1], -1)
    else:
        num_dims = means.shape[-1]
        eye = torch.eye(num_dims, dtype=means.dtype, device=means.device)
        basis = torch.cat([s * eye for s in scales], dim=1)
        y = means @ basis
        y_var = torch.sum((covs @ basis) * basis, dim=-2)
    # expected_sin's mean only: eager torch would compute its unused variance
    # too (XLA drops it), four more passes over the [rows, 96] encoding
    return torch.exp(-0.5 * torch.cat([y_var, y_var], dim=-1)) * torch.sin(torch.cat([y, y + 0.5 * math.pi], dim=-1))


def pos_enc(x, min_deg: int, max_deg: int, append_identity: bool = True):
    """Classic PE in mip's [sin(x), sin(x + pi/2)] form (view directions)."""
    scales = _scales(min_deg, max_deg, x)
    xb = (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], -1)
    enc = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))
    if append_identity:
        enc = torch.cat([x, enc], dim=-1)
    return enc


def sample_along_rays_mip(
    generator: Optional[torch.Generator],
    origins,
    directions,
    radii,
    num_samples: int,
    near,
    far,
    randomized: bool,
    lindisp: bool,
    ray_shape: str = "cone",
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Level-0 sampling: (t_vals [N, S+1], (means, covs))."""
    batch = origins.shape[0]
    t_vals = torch.linspace(0.0, 1.0, num_samples + 1, dtype=origins.dtype, device=origins.device)
    if lindisp:
        t_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    else:
        t_vals = near * (1.0 - t_vals) + far * t_vals
    if randomized and generator is not None:
        mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
        upper = torch.cat([mids, t_vals[..., -1:]], -1)
        lower = torch.cat([t_vals[..., :1], mids], -1)
        t_rand = draw(torch.rand, (batch, num_samples + 1), generator, dtype=origins.dtype, device=origins.device)
        t_vals = lower + (upper - lower) * t_rand
    else:
        t_vals = t_vals.expand(batch, num_samples + 1)
    # radii [N, 1] broadcasts against the [N, S] frustum extents
    return t_vals, cast_rays(t_vals, origins, directions, radii, ray_shape)


def sorted_piecewise_constant_pdf(
    generator: Optional[torch.Generator], bins, weights, num_samples: int, randomized: bool
):
    """Mip-NeRF's inverse-CDF sampler over sorted bins: bins [N, B+1],
    weights [N, B] -> samples [N, num_samples]."""
    eps = 1e-5
    weight_sum = torch.sum(weights, dim=-1, keepdim=True)
    padding = torch.clamp(eps - weight_sum, min=0)
    weights = weights + padding / weights.shape[-1]
    weight_sum = weight_sum + padding

    pdf = weights / weight_sum
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], dim=-1), max=1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf, torch.ones_like(cdf[..., :1])], dim=-1)  # [N, B+1]

    shape = cdf.shape[:-1] + (num_samples,)
    if randomized and generator is not None:
        s = 1 / num_samples
        u = torch.arange(num_samples, dtype=bins.dtype, device=bins.device) * s
        u = u + draw(torch.rand, shape, generator, dtype=bins.dtype, device=bins.device) * (s - _F32_EPS)
        u = torch.clamp(u, max=1.0 - _F32_EPS)
    else:
        u = torch.linspace(0.0, 1.0 - _F32_EPS, num_samples, dtype=bins.dtype, device=bins.device)
        u = u.expand(shape).contiguous()

    # i: the first edge with cdf > u; (i - 1, min(i, B)) bracket u
    last = cdf.shape[-1] - 1
    i = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(i - 1, min=0)
    above = torch.clamp(i, max=last)
    bins_g0, bins_g1 = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    cdf_g0, cdf_g1 = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)

    t = torch.clamp(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0), nan=0.0), 0, 1)
    return bins_g0 + t * (bins_g1 - bins_g0)


def resample_along_rays(
    generator: Optional[torch.Generator],
    origins,
    directions,
    radii,
    t_vals,
    weights,
    randomized: bool,
    ray_shape: str = "cone",
    stop_level_grad: bool = True,
    resample_padding: float = 0.01,
):
    """Blurred-weight PDF resampling for level >= 1: (t_vals, (means, covs))."""
    # max-blur the weight histogram so the PDF is conservative
    weights_pad = torch.cat([weights[..., :1], weights, weights[..., -1:]], dim=-1)
    weights_max = torch.maximum(weights_pad[..., :-1], weights_pad[..., 1:])
    weights_blur = 0.5 * (weights_max[..., :-1] + weights_max[..., 1:])
    weights = weights_blur + resample_padding

    new_t_vals = sorted_piecewise_constant_pdf(generator, t_vals, weights, t_vals.shape[-1], randomized)
    if stop_level_grad:
        new_t_vals = new_t_vals.detach()
    return new_t_vals, cast_rays(new_t_vals, origins, directions, radii, ray_shape)
