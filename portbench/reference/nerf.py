"""Vanilla NeRF (Mildenhall et al. 2020) in plain PyTorch: the weights the
benchmark makes, the rendering of rays (stratified and importance sampling,
the 8 x 256 MLP with the input again at layer 5, compositing over white), the
loss and Adam. float32; ``q`` rounds the MLP's products (``lowp``: the
forward's operands, and with the control's rounding the backward's too).

Parameter names are the flax ones that the port's state dict also uses
(``mlp_coarse.pts_0.weight`` [out, in], ...), so one dict serves both.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .lowp import exact, linear

Params = Dict[str, torch.Tensor]


def mlp_shapes(cfg: Dict) -> List[Tuple[str, int, int]]:
    """(layer, fan_in, fan_out) of one MLP."""
    m = cfg["model"]
    w, depth = m["netwidth"], m["netdepth"]
    cin = 3 * (1 + 2 * m["multires"])
    cv = 3 * (1 + 2 * m["multires_dirs"])
    out = [("pts_0", cin, w)] + [(f"pts_{i}", cin + w if i == 5 else w, w) for i in range(1, depth)]
    return out + [("alpha", w, 1), ("feature", w, w), ("views_0", w + cv, w // 2), ("rgb", w // 2, 3)]


def mlp_names(cfg: Dict) -> List[str]:
    return ["mlp_coarse"] + (["mlp_fine"] if cfg["model"]["n_importance"] else [])


def make_weights(cfg: Dict, seed: int, device) -> Params:
    """Both MLPs' weights from ``seed``, on ``device``, in two draws:
    kernels normal over sqrt(fan_in), biases normal of std ``bias_std``; the
    density head's bias offset by ``sigma_bias``, so that raw density stays
    positive and clear of relu's kink (where the last interval's 1e10 length
    turns a sample from clear to opaque on a rounding) and every ray is
    opaque within its first samples, as a ray that meets a surface."""
    shapes = [(f"{mlp}.{name}", i, o) for mlp in mlp_names(cfg) for name, i, o in mlp_shapes(cfg)]
    g = torch.Generator(device=device).manual_seed(seed)
    kern = torch.randn(sum(i * o for _, i, o in shapes), generator=g, device=device)
    bias = torch.randn(sum(o for _, _, o in shapes), generator=g, device=device) * cfg["weights"]["bias_std"]
    out, ko, bo = {}, 0, 0
    for name, i, o in shapes:
        out[f"{name}.weight"] = (kern[ko:ko + i * o].view(o, i) / math.sqrt(i)).contiguous()
        out[f"{name}.bias"] = bias[bo:bo + o].contiguous()
        ko, bo = ko + i * o, bo + o
    for mlp in mlp_names(cfg):
        out[f"{mlp}.alpha.bias"] += cfg["weights"]["sigma_bias"]
    return out


def posenc(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x), cos(2^(L-1) x)]."""
    freqs = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2).reshape(*x.shape[:-1], -1)
    return torch.cat([x, enc], dim=-1)


def mlp(p: Params, prefix: str, x: torch.Tensor, v: torch.Tensor, q: Callable = exact):
    """(raw rgb [n, 3], raw sigma [n]) of encoded points x and views v."""
    def lin(name, h):
        return linear(h, p[f"{prefix}.{name}.weight"], p[f"{prefix}.{name}.bias"], q)

    h = x
    for i in range(8):
        h = F.relu(lin(f"pts_{i}", h))
        if i == 4:
            h = torch.cat([x, h], dim=-1)
    sigma = lin("alpha", h)[:, 0]
    feat = lin("feature", h)
    rgb = lin("rgb", F.relu(lin("views_0", torch.cat([feat, v], dim=-1))))
    return rgb, sigma


def composite(raw_rgb, raw_sigma, z, rays_d):
    """(rgb over white, weights) of one pass."""
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-F.relu(raw_sigma) * dists)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha[:, :-1] + 1e-10], dim=-1), dim=-1)
    weights = alpha * trans
    rgb = (weights[..., None] * torch.sigmoid(raw_rgb)).sum(dim=1)
    return rgb + (1.0 - weights.sum(dim=1, keepdim=True)), weights


def sample_pdf(bins, weights, u):
    """Inverse-CDF samples at ``u`` [n, k] of the histogram of ``weights``
    over the bin edges ``bins``."""
    weights = weights.detach() + 1e-5
    cdf = torch.cumsum(weights / weights.sum(dim=-1, keepdim=True), dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = (inds - 1).clamp(min=0)
    above = inds.clamp(max=cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(-1, below), cdf.gather(-1, above)
    b0, b1 = bins.gather(-1, below), bins.gather(-1, above)
    denom = torch.where(c1 - c0 < 1e-5, torch.ones_like(c1), c1 - c0)
    return (b0 + (u - c0) / denom * (b1 - b0)).detach()


def render(p: Params, cfg: Dict, rays: Dict[str, torch.Tensor], u_strat: Optional[torch.Tensor] = None,
           u_pdf: Optional[torch.Tensor] = None, q: Callable = exact) -> Dict[str, torch.Tensor]:
    """Coarse and fine rgb of the rays. Without draws the samples are the
    deterministic ones of serving (strata's edges, evenly spaced CDF)."""
    m = cfg["model"]
    o, d, near, far = rays["rays_o"], rays["rays_d"], rays["near"], rays["far"]
    n, S, I = o.shape[0], m["n_samples"], m["n_importance"]
    viewdirs = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    t = torch.linspace(0.0, 1.0, S, device=o.device)
    z = near * (1.0 - t) + far * t
    if u_strat is not None:
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        lower = torch.cat([z[:, :1], mids], -1)
        upper = torch.cat([mids, z[:, -1:]], -1)
        z = lower + (upper - lower) * u_strat
    venc = posenc(viewdirs, m["multires_dirs"])

    def run(prefix, zs):
        k = zs.shape[1]
        pts = o[:, None, :] + d[:, None, :] * zs[..., None]
        x = posenc(pts.reshape(n * k, 3), m["multires"])
        v = venc[:, None, :].expand(n, k, venc.shape[-1]).reshape(n * k, -1)
        rgb, sigma = mlp(p, prefix, x, v, q)
        return composite(rgb.view(n, k, 3), sigma.view(n, k), zs, d)

    rgb_c, w_c = run("mlp_coarse", z)
    out = {"coarse_rgb": rgb_c, "rgb": rgb_c}
    if I:
        u = u_pdf if u_pdf is not None else torch.linspace(0.0, 1.0, I, device=o.device).expand(n, I)
        z_f = sample_pdf(0.5 * (z[:, 1:] + z[:, :-1]), w_c[:, 1:-1], u)
        out["rgb"], _ = run("mlp_fine", torch.sort(torch.cat([z, z_f], -1), dim=-1)[0])
    return out


def lr_at(opt: Dict, step: int) -> float:
    """NeRF's exponential decay: lr * rate^(step / decay_steps)."""
    return opt["lr"] * opt["lr_decay_rate"] ** (step / opt["lr_decay_steps"])


def adam(p: Params, grads: Params, state: Dict, opt: Dict, step: int) -> Params:
    """One Adam step (bias-corrected, eps outside the root) at ``lr_at(step)``."""
    b1, b2, eps = opt.get("beta1", 0.9), opt.get("beta2", 0.999), opt.get("eps", 1e-8)
    t = step + 1
    out = {}
    for k, w in p.items():
        m, v = state.setdefault(k, (torch.zeros_like(w), torch.zeros_like(w)))
        g = grads[k]
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        state[k] = (m, v)
        denom = (v / (1 - b2**t)).sqrt() + eps
        out[k] = w - lr_at(opt, step) / (1 - b1**t) * m / denom
    return out


def train(p0: Params, cfg: Dict, batches: List[Dict[str, torch.Tensor]], draws: List[Tuple[torch.Tensor, torch.Tensor]],
          block: int, q: Callable = exact):
    """Adam steps over ``batches`` from ``p0``, each batch in blocks of
    ``block`` rays (the loss is a mean over rays, so the blocks' gradients
    add up): (losses, first step's gradients, parameters after the last)."""
    p = {k: v.clone() for k, v in p0.items()}
    state, losses, first = {}, [], None
    for step, (batch, (u_s, u_p)) in enumerate(zip(batches, draws)):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        n = batch["target"].shape[0]
        total = 0.0
        for s in range(0, n, block):
            rows = slice(s, s + block)
            out = render(leaves, cfg, {k: v[rows] for k, v in batch.items()}, u_s[rows], u_p[rows], q)
            sq = ((out["rgb"] - batch["target"][rows]) ** 2).sum() + ((out["coarse_rgb"] - batch["target"][rows]) ** 2).sum()
            loss = sq / (3 * n)
            loss.backward()
            total += float(loss.detach())
        grads = {k: v.grad for k, v in leaves.items()}
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        losses.append(total)
        p = adam({k: v.detach() for k, v in leaves.items()}, grads, state, cfg["optimizer"], step)
    return losses, first, p
