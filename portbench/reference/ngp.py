"""Instant-NGP (Mueller et al. 2022) in plain PyTorch: the weights the
benchmark makes, the multiresolution hash encoding (16 levels, trilinear over
the cell's 8 corners, NGP's spatial hash above the dense levels), the two
tiny MLPs, spherical harmonics of degree 4, the occupancy grid (cells seen by
the training cameras, density refreshes from a generator's draws, the
bitfield), the march (``n_candidates`` even steps through the unit cube, the
first ``n_keep`` occupied ones kept), the per-chunk sample budget and
compositing over white. float32; ``q`` rounds the MLPs' operands (``lowp``).

Weights are stored [in, out] under the port's fused layout's names
(``field.d_w1``, ..., ``field.encoding.table`` [L, T, F]).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from .lowp import exact

Params = Dict[str, torch.Tensor]
SQRT3 = 1.7320508075688772
PRIMES = (1, 2654435761, 805459861)
CORNERS = [(i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)]


def resolutions(m: Dict) -> List[int]:
    scale = float(np.exp2(np.log2(m["max_res"] / m["base_res"]) / max(m["n_levels"] - 1, 1)))
    return [int(r) for r in np.floor(m["base_res"] * scale ** np.arange(m["n_levels"])).astype(np.int64)]


def mlp_shapes(m: Dict) -> List[Tuple[str, int, int]]:
    h, g, enc = m["hidden_dim"], m["geo_feat_dim"], m["n_levels"] * m["n_features"]
    return [("d_w1", enc, h), ("d_w2", h, 1 + g), ("c_w1", g + 16, h), ("c_w2", h, h), ("c_w3", h, 3)]


def make_weights(cfg: Dict, seed: int, device) -> Params:
    """The table uniform in +-``table_scale`` and the MLPs' kernels normal
    over sqrt(fan_in), from ``seed`` on ``device``; zero biases. The density
    column is scaled by ``sigma_scale`` and its bias set so that a share
    ``share_above`` of uniform points lies above the grid's threshold (see
    :func:`calibrate`)."""
    m, w = cfg["model"], cfg["weights"]
    g = torch.Generator(device=device).manual_seed(seed)
    T = 1 << m["log2_table_size"]
    p = {"field.encoding.table": (torch.rand((m["n_levels"], T, m["n_features"]), generator=g, device=device) * 2 - 1)
         * w["table_scale"]}
    shapes = mlp_shapes(m)
    kern = torch.randn(sum(i * o for _, i, o in shapes), generator=g, device=device)
    ko = 0
    for name, i, o in shapes:
        p[f"field.{name}"] = (kern[ko:ko + i * o].view(i, o) / math.sqrt(i)).contiguous()
        p[f"field.{name.replace('w', 'b')}"] = torch.zeros(o, device=device)
        ko += i * o
    p["field.d_w2"][:, 0] *= w["sigma_scale"]
    calibrate(p, cfg, g)
    return p


def calibrate(p: Params, cfg: Dict, g: torch.Generator) -> None:
    """Set the density bias so that raw density, at ``calibration_points``
    uniform points, exceeds log(threshold * n_candidates / sqrt(3)) (the
    grid's bar) on a share ``share_above`` of them."""
    m, w = cfg["model"], cfg["weights"]
    pts = torch.rand((w["calibration_points"], 3), generator=g, device=p["field.d_w1"].device)
    raw = density_raw(p, m, pts)[0]
    bar = math.log(m["density_threshold"] * m["n_candidates"] / SQRT3)
    p["field.d_b2"][0] = bar - torch.quantile(raw, 1.0 - w["share_above"])


def encode(p: Params, m: Dict, x: torch.Tensor) -> torch.Tensor:
    """[n, 3] in [0, 1] -> [n, L * F], level-major."""
    table = p["field.encoding.table"]
    T = table.shape[1]
    outs = []
    for lvl, res in enumerate(resolutions(m)):
        xl = x * float(res - 1)
        x0 = torch.floor(xl)
        t = xl - x0
        xi = x0.long()
        ax = [((xi[:, d]).clamp(0, res - 1), (xi[:, d] + 1).clamp(0, res - 1)) for d in range(3)]
        feats = 0.0
        for i, j, k in CORNERS:
            cx, cy, cz = ax[0][i], ax[1][j], ax[2][k]
            if res**3 <= T:
                idx = (cx + res * cy + res * res * cz) & (T - 1)
            else:
                idx = (cx * PRIMES[0] ^ cy * PRIMES[1] ^ cz * PRIMES[2]) & (T - 1)
            wgt = (t[:, 0] if i else 1 - t[:, 0]) * (t[:, 1] if j else 1 - t[:, 1]) * (t[:, 2] if k else 1 - t[:, 2])
            feats = feats + table[lvl][idx] * wgt[:, None]
        outs.append(feats)
    return torch.cat(outs, dim=-1)


def density_raw(p: Params, m: Dict, x: torch.Tensor, q: Callable = exact):
    """(raw sigma [n], geo features [n, G]) at [n, 3] points."""
    enc = encode(p, m, x)
    h = torch.relu(q(enc) @ q(p["field.d_w1"]) + p["field.d_b1"])
    h = q(h) @ q(p["field.d_w2"]) + p["field.d_b2"]
    return h[:, 0], h[:, 1:]


def sh4(d: torch.Tensor) -> torch.Tensor:
    """The 16 real spherical harmonics of degree < 4 of unit directions."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814), -0.48860251190291987 * y, 0.48860251190291987 * z,
        -0.48860251190291987 * x, 1.0925484305920792 * xy, -1.0925484305920792 * yz,
        0.94617469575755997 * zz - 0.31539156525251999, -1.0925484305920792 * xz, 0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (-3.0 * xx + yy), 2.8906114426405538 * xy * z, 0.45704579946446572 * y * (1.0 - 5.0 * zz),
        0.3731763325901154 * z * (5.0 * zz - 3.0), 0.45704579946446572 * x * (1.0 - 5.0 * zz),
        1.4453057213202769 * z * (xx - yy), 0.59004358992664352 * x * (-xx + 3.0 * yy),
    ], dim=-1)


def field(p: Params, m: Dict, x: torch.Tensor, d: torch.Tensor, q: Callable = exact):
    """(raw rgb [n, 3], raw sigma [n]) at points x with unit directions d."""
    sigma, geo = density_raw(p, m, x, q)
    h = torch.cat([geo, sh4(d)], dim=-1)
    h = torch.relu(q(h) @ q(p["field.c_w1"]) + p["field.c_b1"])
    h = torch.relu(q(h) @ q(p["field.c_w2"]) + p["field.c_b2"])
    return q(h) @ q(p["field.c_w3"]) + p["field.c_b3"], sigma


# --- the occupancy grid ---------------------------------------------------------------


def cell_centers(cells: torch.Tensor, res: int) -> torch.Tensor:
    """Centres in [0, 1]^3 of raster cells x + R (y + R z), rounded as NGP's
    cascade form (p - 1/2) 2^c + 1/2 rounds them at cascade 0."""
    x, y, z = cells % res, (cells // res) % res, cells // (res * res)
    return ((torch.stack([x, y, z], -1).float() + 0.5) / res - 0.5) * 1.0 + 0.5


def untrained_grid(poses_ngp: np.ndarray, focal: float, H: int, W: int, res: int, device) -> torch.Tensor:
    """[R^3] density: 0 where a training camera sees the cell's centre, -1
    elsewhere (such cells are never refreshed nor marched)."""
    centers = cell_centers(torch.arange(res**3, device=device), res)
    seen = torch.zeros(res**3, dtype=torch.bool, device=device)
    for c2w in torch.as_tensor(np.asarray(poses_ngp, np.float32), device=device):
        cam = (centers - c2w[:3, 3]) @ c2w[:3, :3]
        z = -cam[:, 2]
        zc = z.clamp(min=1e-6)
        seen |= ((z > 1e-6) & ((cam[:, 0] / zc).abs() < 0.5 * W / focal + 0.5 / res)
                 & ((cam[:, 1] / zc).abs() < 0.5 * H / focal + 0.5 / res))
    return torch.where(seen, 0.0, -1.0)


def refresh(p: Params, m: Dict, density: torch.Tensor, g: torch.Generator, q: Callable = exact) -> torch.Tensor:
    """One density refresh with the generator's draws, in the order that
    NGP's refresh takes them: the biased half's uniforms (f64), the uniform
    half's cells, the biased half's fallback cells, the jitter."""
    res = m["grid_res"]
    n = res**3
    total = m["grid_update_samples"]
    n_uni, n_bia = total // 2, total - total // 2
    dev = density.device
    occupied = (density > 0.0).sum().clamp(min=1)
    u = torch.rand(n_bia, generator=g, dtype=torch.float64, device=dev)
    uni = torch.randint(0, n, (n_uni,), generator=g, device=dev)
    rank = torch.minimum((u * occupied).long() + 1, occupied)
    fallback = torch.randint(0, n, (n_bia,), generator=g, device=dev)
    jitter = torch.rand((total, 3), generator=g, device=dev)
    cdf = torch.cumsum((density > 0.0).long(), dim=0)
    biased = torch.where(cdf[-1] > 0, torch.searchsorted(cdf, rank).clamp(0, n - 1), fallback)
    cells = torch.cat([uni, biased])
    pos = cell_centers(cells, res) + (jitter - 0.5) / res * 1.0
    sigma = torch.exp(density_raw(p, m, pos, q)[0].clamp(-15.0, 15.0)) * (SQRT3 / m["n_candidates"])
    splat = (density * 0.95).scatter_reduce(0, cells, sigma, "amax", include_self=True)
    return torch.where(density < 0, density, splat)


def bitfield(density: torch.Tensor, threshold: float) -> torch.Tensor:
    """Occupied: density above min(mean over the seen cells, threshold)."""
    valid = density >= 0
    mean = torch.where(valid, density, 0.0).sum() / valid.sum().clamp(min=1)
    return (density > mean.clamp(max=threshold)) & valid


# --- marching and compositing ------------------------------------------------------------


def candidates(bits: torch.Tensor, m: Dict, o: torch.Tensor, d: torch.Tensor):
    """Per ray its unit direction, the candidates' distances z [n, S], step
    dt [n, 1], far end [n, 1] and occupied flags [n, S]."""
    res, S = m["grid_res"], m["n_candidates"]
    dirs = d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp(min=1e-10)
    inv = 1.0 / torch.where(dirs.abs() > 1e-10, dirs, 1e-10)
    t0, t1 = (0.0 - o) * inv, (1.0 - o) * inv
    t_near = torch.minimum(t0, t1).amax(dim=-1).clamp(min=0.0)
    t_far = torch.maximum(torch.maximum(t0, t1).amin(dim=-1), t_near)
    span = (t_far - t_near)[:, None]
    z = t_near[:, None] + torch.linspace(0.0, 1.0, S, device=o.device) * span
    pts = o[:, None, :] + dirs[:, None, :] * z[..., None]
    cell01 = (pts - 0.5) / 1.0 + 0.5
    xi = torch.floor(cell01 * res).long()
    inside = ((xi >= 0) & (xi < res)).all(dim=-1)
    xi = xi.clamp(0, res - 1)
    live = bits[xi[..., 0] + res * (xi[..., 1] + res * xi[..., 2])] & inside & (z < t_far[:, None])
    return dirs, z, span / S, t_far[:, None], live


def kept_per_ray(bits: torch.Tensor, m: Dict, o: torch.Tensor, d: torch.Tensor, block: int = 16384) -> torch.Tensor:
    """[n] the samples each ray keeps: min(occupied candidates, n_keep)."""
    out = [candidates(bits, m, o[s:s + block], d[s:s + block])[-1].sum(-1).clamp(max=m["n_keep"])
           for s in range(0, o.shape[0], block)]
    return torch.cat(out)


def render(p: Params, m: Dict, bits: torch.Tensor, o: torch.Tensor, d: torch.Tensor, before: torch.Tensor,
           q: Callable = exact) -> torch.Tensor:
    """rgb [n, 3] over white of rays (o, d). ``before`` [n]: the samples that
    the rays before each one in its chunk keep; a sample whose place in its
    chunk is past ``sample_budget`` is dropped (density exp(-15), rgb 1/2)."""
    K = m["n_keep"]
    dirs, z, dt, t_far, live = candidates(bits, m, o, d)
    rank = torch.cumsum(live.long(), dim=-1) - 1
    keep = live & (rank < K)
    n = o.shape[0]
    zk = torch.zeros((n, K), device=o.device).masked_scatter_(
        torch.arange(K, device=o.device)[None] < keep.sum(-1, keepdim=True), z[keep])
    mask = torch.arange(K, device=o.device)[None] < keep.sum(-1, keepdim=True)
    zk = torch.where(mask, zk, t_far)
    pts = (o[:, None, :] + dirs[:, None, :] * zk[..., None]).clamp(0.0, 1.0)
    rgb_raw, sig_raw = field(p, m, pts[mask], dirs[:, None, :].expand(n, K, 3)[mask], q)
    raw_rgb = torch.zeros((n, K, 3), device=o.device).index_put_((mask,), rgb_raw)
    raw_sigma = torch.zeros((n, K), device=o.device).index_put_((mask,), sig_raw)
    dropped = (before[:, None] + torch.arange(K, device=o.device)[None]) >= m["sample_budget"]
    raw_rgb = torch.where((mask & dropped)[..., None], 0.0, raw_rgb)
    raw_sigma = torch.where(mask & dropped, -1e4, raw_sigma)
    sigma = torch.where(mask, torch.exp(raw_sigma.clamp(-15.0, 15.0)), 0.0)
    alpha = 1.0 - torch.exp(-sigma * dt)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha[:, :-1] + 1e-10], dim=-1), dim=-1)
    w = alpha * trans
    return (w[..., None] * torch.sigmoid(raw_rgb)).sum(1) + (1.0 - w.sum(1, keepdim=True))
