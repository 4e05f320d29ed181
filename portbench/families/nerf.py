"""Vanilla NeRF (``NerfNetwork``) in the port, and its reference's side of
each check."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..lib import rays as lrays
from ..reference import nerf as ref
from ..reference.lowp import rounding

# The layers a traced run wraps in spans: the MLP's forward (the fused
# kernel, or its plain version) and, through the autograd graph, its backward.
LAYERS = ("nerf_mlp",)


def build(cfg: Dict, device):
    from xrnerf_torch import build_network

    return build_network(dict(cfg["model"]), device=device)


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return ref.make_weights(cfg, seed, device)


def load(net, weights: Dict[str, torch.Tensor]) -> None:
    net.load_state_dict(weights, strict=True)


def layer_modules(net) -> Dict[str, List[torch.nn.Module]]:
    return {"nerf_mlp": [m for m in (getattr(net, "mlp_coarse", None), getattr(net, "mlp_fine", None)) if m is not None]}


def cameras(cfg: Dict, traffic: Dict):
    """What the Trainer's dataset has to offer at construction: nothing."""
    return None


def prepare_serving(trainer, cfg: Dict, traffic: Dict, seed: int) -> Dict:
    return {}


def frame_rays(cfg: Dict, traffic: Dict, pose: np.ndarray) -> Dict[str, np.ndarray]:
    H = W = traffic["size"]
    K = lrays.intrinsics(H, W, lrays.focal_of(W, traffic["camera_angle_x"]))
    o, d = lrays.image_rays(H, W, K, pose)
    n = H * W
    return {"rays_o": o, "rays_d": d, "near": np.full((n, 1), cfg["near"], np.float32),
            "far": np.full((n, 1), cfg["far"], np.float32)}


def render_frames(weights, cfg: Dict, frames: List[Dict], q, device) -> List[torch.Tensor]:
    """The reference's rgb of each frame's sampled rays (``frames[i]``:
    ``rays`` the sampled rays as numpy)."""
    out = []
    for fr in frames:
        r = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in fr["rays"].items()}
        with torch.no_grad():
            out.append(torch.cat([ref.render(weights, cfg, {k: v[s:s + 2048] for k, v in r.items()}, q=q)["rgb"]
                                  for s in range(0, r["rays_o"].shape[0], 2048)]))
    return out


def reference_frames(weights, cfg: Dict, traffic: Dict, seed: int, served: Dict, device) -> Dict:
    """The reference's rgb of the served frames' sampled rays, in float32;
    every ray is compared."""
    frames = served["frames"]
    return {"rgb": render_frames(weights, cfg, frames, rounding("float32"), device), "keep": [None] * len(frames),
            "checks": {}, "info": {}}


def control_frames(weights, cfg: Dict, traffic: Dict, seed: int, frames: List[Dict], pose_rays, q, device):
    """The reference at ``q`` in the port's place."""
    return render_frames(weights, cfg, frames, q, device), {}


def flop_per_ray(cfg: Dict, train: bool) -> float:
    """The MLP work of one ray (``lib/flops.py``): forward, and in training
    the backward at twice it."""
    from ..lib import flops

    return flops.nerf_train_flop_per_ray(cfg) if train else flops.nerf_render_flop_per_ray(cfg)
