"""Instant-NGP (``HashNerfNetwork``) in the port, and its reference's side
of each check.

Serving needs the occupancy grid: the Trainer's construction marks the cells
that no training camera sees (``init_aux``), then ``Trainer.update_aux``
refreshes it ``grid_refreshes`` times from the cell's weights, at the steps a
training run would (0, 16, 32, ...), each from its own seeded stream.

The reference works the grid out again from the same weights and the same
draws, at the precision that the configuration states (the encoding and the
tiny MLPs' operands rounded to bf16), and marches the frames through its own
grid. The grid is a threshold of densities, so a cell whose density lies
within the products' f32 rounding of the threshold can fall either way: the
share of the reference's occupied cells on which the served grid differs is
a number of its own, and a sampled ray is left out of the frames' error
where the two grids differ on its candidates or give its samples another
place in the chunk's budget (``rays_left_out``, the share of them).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..lib import rays as lrays
from ..reference import ngp as ref
from ..reference.lowp import rounding

LAYERS = ("ngp_field",)


class OrbitCameras:
    """The training cameras, as ``HashNerfNetwork.init_aux`` reads them:
    the orbit in NGP's coordinates, focal and image size."""

    def __init__(self, traffic: Dict):
        self.H = self.W = traffic["size"]
        self.focal = lrays.focal_of(self.W, traffic["camera_angle_x"])
        self.poses_ngp = np.stack([lrays.nerf2ngp(p) for p in lrays.orbit(traffic["poses"])])
        self.i_train = np.arange(len(self.poses_ngp))


def build(cfg: Dict, device):
    from xrnerf_torch import build_network

    return build_network(dict(cfg["model"]), device=device)


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return ref.make_weights(cfg, seed, device)


UNFUSED = {"d_w1": "density_net.0", "d_w2": "density_net.2", "c_w1": "color_net.0", "c_w2": "color_net.2",
           "c_w3": "color_net.4"}


def load(net, weights: Dict[str, torch.Tensor]) -> None:
    """The weights into the network, in its fused or its plain layout (the
    plain one holds each kernel transposed, as ``nn.Linear``)."""
    if not net.field.fused:
        weights = dict(weights)
        for w, lin in UNFUSED.items():
            weights[f"field.{lin}.weight"] = weights.pop(f"field.{w}").t().contiguous()
            weights[f"field.{lin}.bias"] = weights.pop(f"field.{w.replace('w', 'b')}")
    missing, unexpected = net.load_state_dict(weights, strict=False)
    if unexpected or set(missing) != {"grid_density", "grid_bitfield"}:
        raise KeyError(f"weights do not fit the network: missing {missing}, unexpected {unexpected}")


def layer_modules(net) -> Dict[str, List[torch.nn.Module]]:
    return {"ngp_field": [net.field]}


def cameras(cfg: Dict, traffic: Dict):
    return OrbitCameras(traffic)


def refresh_steps(cfg: Dict) -> List[int]:
    return [16 * i for i in range(cfg["grid_refreshes"])]


def prepare_serving(trainer, cfg: Dict, traffic: Dict, seed: int) -> Dict:
    """Refresh the grid; returns what the check needs of the port's state
    and what a run prints of the grid."""
    for step in refresh_steps(cfg):
        trainer.update_aux(step)
    net = trainer.eval_network
    bits = net.grid_bitfield.reshape(-1).clone()
    seen = (net.grid_density >= 0).sum()
    return {"bitfield": bits, "info": {"occupied_share": float(bits.sum()) / float(bits.numel()),
                                       "seen_share": float(seen) / float(bits.numel())}}


def frame_rays(cfg: Dict, traffic: Dict, pose: np.ndarray) -> Dict[str, np.ndarray]:
    H = W = traffic["size"]
    K = lrays.intrinsics(H, W, lrays.focal_of(W, traffic["camera_angle_x"]))
    o, d = lrays.image_rays(H, W, K, lrays.nerf2ngp(pose))
    return {"rays_o": o, "rays_d": d}


def _before(kept: torch.Tensor, chunk: int) -> torch.Tensor:
    """[n] samples that the rays before each one in its chunk keep."""
    csum = torch.cumsum(kept, 0) - kept
    start = (torch.arange(kept.shape[0], device=kept.device) // chunk) * chunk
    return csum - csum[start]


def reference_rounding(cfg: Dict):
    """The products' rounding that the configuration states: bf16, or f32
    where the field runs in float32 (the plain path of the CPU tests)."""
    return rounding("float32" if cfg["model"].get("dtype") == "float32" else "bf16")


def _rays(fr: Dict, device):
    return [torch.from_numpy(np.ascontiguousarray(fr["rays"][k])).to(device) for k in ("rays_o", "rays_d")]


def _befores(bits: torch.Tensor, cfg: Dict, frames: List[Dict], pose_rays, device) -> Dict[int, torch.Tensor]:
    """Per pose, per ray of the whole frame, the samples that the rays
    before it in its chunk keep when marched through ``bits``."""
    out = {}
    for fr in frames:
        if fr["pose"] not in out:
            full = pose_rays(fr["pose"])
            o, d = (torch.from_numpy(full[k]).to(device) for k in ("rays_o", "rays_d"))
            out[fr["pose"]] = _before(ref.kept_per_ray(bits, cfg["model"], o, d), cfg["eval_chunk"])
    return out


def render_frames(weights, cfg: Dict, frames: List[Dict], bits: torch.Tensor, befores, q, device) -> List[torch.Tensor]:
    """The rgb of each frame's sampled rays, marched through ``bits``, each
    chunk's sample budget from ``befores`` (:func:`_befores` of ``bits``)."""
    m = dict(cfg["model"])
    out = []
    with torch.no_grad():
        for fr in frames:
            before = befores[fr["pose"]][torch.from_numpy(fr["idx"]).to(device)]
            o, d = _rays(fr, device)
            out.append(torch.cat([ref.render(weights, m, bits, o[s:s + 4096], d[s:s + 4096], before[s:s + 4096], q)
                                  for s in range(0, o.shape[0], 4096)]))
    return out


def _comparable(cfg: Dict, frames: List[Dict], want_bits, bw, got_bits, bg, device) -> List[torch.Tensor]:
    """Per frame, which sampled rays the two grids (with their ``_befores``)
    march alike: the same occupied candidates and the same number of samples
    past the budget."""
    m = cfg["model"]
    K, budget = m["n_keep"], m["sample_budget"]
    with torch.no_grad():
        out = []
        for fr in frames:
            idx = torch.from_numpy(fr["idx"]).to(device)
            o, d = _rays(fr, device)
            keep = []
            for s in range(0, o.shape[0], 4096):
                lw = ref.candidates(want_bits, m, o[s:s + 4096], d[s:s + 4096])[-1]
                lg = ref.candidates(got_bits, m, o[s:s + 4096], d[s:s + 4096])[-1]
                kept = lw.sum(-1).clamp(max=K)
                i = idx[s:s + 4096]
                drop_w = (bw[fr["pose"]][i] + kept - budget).clamp(min=0)
                drop_g = (bg[fr["pose"]][i] + kept - budget).clamp(min=0)
                keep.append(~(lw != lg).any(-1) & (torch.minimum(drop_w, kept) == torch.minimum(drop_g, kept)))
            out.append(torch.cat(keep))
    return out


def reference_grid(weights, cfg: Dict, traffic: Dict, seed: int, q, device) -> torch.Tensor:
    """The bitfield that the reference derives from the weights and the
    refreshes' draws (the Trainer's streams: seed * 2^32 + 2^31 + step)."""
    m = cfg["model"]
    cams = OrbitCameras(traffic)
    density = ref.untrained_grid(cams.poses_ngp, cams.focal, cams.H, cams.W, m["grid_res"], device)
    with torch.no_grad():
        for step in refresh_steps(cfg):
            g = torch.Generator(device=device).manual_seed(seed * 2**32 + 2**31 + step)
            density = ref.refresh(weights, m, density, g, q)
    return ref.bitfield(density, m["density_threshold"])


def reference_frames(weights, cfg: Dict, traffic: Dict, seed: int, served: Dict, device) -> Dict:
    """The reference's rgb of the served frames' sampled rays, through its
    own grid; which of them to compare; the grid's own number; the share of
    rays left out."""
    q = reference_rounding(cfg)
    want = reference_grid(weights, cfg, traffic, seed, q, device)
    got = served["bitfield"]
    frames, pose_rays = served["frames"], served["pose_rays"]
    bw = _befores(want, cfg, frames, pose_rays, device)
    keep = _comparable(cfg, frames, want, bw, got, _befores(got, cfg, frames, pose_rays, device), device)
    n = sum(k.numel() for k in keep)
    return {"rgb": render_frames(weights, cfg, frames, want, bw, q, device), "keep": keep,
            "checks": {"grid_cells_differ": float((want != got).sum()) / max(float(want.sum()), 1.0)},
            "info": {"rays_left_out": 1.0 - sum(float(k.sum()) for k in keep) / max(n, 1)}}


def control_frames(weights, cfg: Dict, traffic: Dict, seed: int, frames: List[Dict], pose_rays, q, device):
    """The reference at ``q`` in the port's place: its grid, and its rgb of
    the frames' sampled rays marched through it."""
    bits = reference_grid(weights, cfg, traffic, seed, q, device)
    befores = _befores(bits, cfg, frames, pose_rays, device)
    return render_frames(weights, cfg, frames, bits, befores, q, device), {"bitfield": bits}
