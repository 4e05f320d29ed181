"""Serving traffic: one client in a closed loop asks for novel views along
the orbit (``poses`` evenly spaced, starting at a pose drawn from the seed)
through ``Trainer.render_image`` and waits for each frame's RGB on the host.

Set-up builds the Trainer, loads the benchmark's weights, lets the family
prepare what serving needs (Instant-NGP's grid), makes every pose's rays and
renders ``warmup_frames`` frames. The window opens after them and closes at
the end of the frame that crosses ``seconds``. ``frame_ms`` is the window over
its frames; ``frame_ms_p95`` the 95th percentile of all their latencies,
each timed from the request to the RGB on the host.

The check: of every frame in the window, ``check_pixels`` pixels drawn from
the seed, the served RGB against the reference's render of the same rays;
per frame the root-mean-square error over the rays that the family compares
(Instant-NGP leaves out those that its two grids march differently), and
the worst frame's is compared.
"""

from __future__ import annotations

import gc
from typing import Dict, Optional

import numpy as np
import torch

from ..lib import rays as lrays
from ..lib.stats import percentile
from ..reference.lowp import rounding
from .common import Cell, RunRecord, now, sync, traced_slices, wrap_layers


def poses_of(cell: Cell) -> np.ndarray:
    return lrays.orbit(cell.traffic["poses"])


def run(cell: Cell) -> RunRecord:
    from xrnerf_torch.core.trainer import Trainer

    rec = RunRecord(cell)
    cfg, t, fam = cell.cfg, cell.traffic, cell.family
    net = fam.build(cfg, cell.device)
    tr = Trainer(net, fam.cameras(cfg, t), work_dir=None, ckpt_interval=0, eval_chunk=cfg["eval_chunk"],
                 seed=cell.seed, device=cell.device)
    weights = fam.make_weights(cfg, cell.seed, cell.device)
    fam.load(tr.network, weights)
    served = fam.prepare_serving(tr, cfg, t, cell.seed)
    rec.info.update(served.pop("info", {}))
    poses = poses_of(cell)
    pose_rays = [fam.frame_rays(cfg, t, p) for p in poses]
    H = W = t["size"]
    rng = np.random.RandomState(cell.seed % 2**32)
    first = rng.randint(len(poses))
    for w in range(t["warmup_frames"]):
        tr.render_image(pose_rays[(first - 1 - w) % len(poses)], H, W)
    if cell.trace:
        wrap_layers(fam.layer_modules(tr.eval_network))
    slices = traced_slices(cell.device, t["trace_after"], t["trace_frames"]) if cell.trace else []

    sync(cell.device)
    t_open = now()
    latencies, frames, failed, i = [], [], 0, 0
    while True:
        for begin, _, sl in slices:
            if i == begin:
                sl.start()
        pi = (first + i) % len(poses)
        t0 = now()
        out = tr.render_image(pose_rays[pi], H, W)
        t1 = now()
        for _, end, sl in slices:
            if i + 1 == end:
                sl.stop()
        latencies.append(t1 - t0)
        rgb = out["rgb"].reshape(-1, 3)
        idx = rng.randint(H * W, size=t["check_pixels"])
        failed += int(rgb.shape[0] != H * W or not np.isfinite(rgb).all())
        frames.append({"pose": pi, "idx": idx, "rgb": rgb[idx].copy(),
                       "rays": {k: v[idx] for k, v in pose_rays[pi].items()}})
        i += 1
        if t1 - t_open >= cell.seconds and all(sl.events is not None for _, _, sl in slices):
            break
    window_s = t1 - t_open

    rec.attempted, rec.failed = len(frames), failed
    rec.end_to_end = {"setup_s": t_open - cell.t_start, "frame_ms": 1e3 * window_s / len(frames),
                      "frame_ms_p95": 1e3 * percentile(latencies, 95.0)}
    rec.counters = {"window_s": window_s, "frames": len(frames), "rays_per_frame": H * W,
                    "slice_frames": t["trace_frames"]}
    if slices:
        rec.summary, rec.idle = (sl.summary(fam.LAYERS) for _, _, sl in slices)
    rec.memory_peak_bytes = torch.cuda.max_memory_allocated() if torch.device(cell.device).type == "cuda" else 0
    served["frames"] = frames
    served["pose_rays"] = lambda k: pose_rays[k]
    del tr, net, out
    gc.collect()
    if torch.device(cell.device).type == "cuda":
        torch.cuda.empty_cache()
    rec.checks = check(cell, weights, served, rec.info)
    return rec


def check(cell: Cell, weights, served: Dict, info: Optional[Dict] = None) -> Dict[str, float]:
    """The worst frame's RMSE of the served RGB against the reference's at
    the sampled pixels (those the family compares), and whatever else the
    family holds by itself; what the family tells of the check goes into
    ``info``."""
    ref = cell.family.reference_frames(weights, cell.cfg, cell.traffic, cell.seed, served, cell.device)
    worst = 0.0
    for fr, want, keep in zip(served["frames"], ref["rgb"], ref["keep"]):
        sq = ((torch.from_numpy(fr["rgb"]).to(want.device) - want) ** 2).mean(-1)
        sq = sq if keep is None else sq[keep]
        if sq.numel():
            worst = max(worst, float(sq.mean().sqrt()))
    if info is not None:
        info.update(ref["info"])
    return {"worst_frame_rmse": worst, **ref["checks"]}


def control(cell: Cell, frames: int, info: Optional[Dict] = None) -> Dict[str, float]:
    """The check with the reference computed in fp8 in the port's place, on
    ``frames`` frames of the orbit from the seed's first pose."""
    fam, cfg, t = cell.family, cell.cfg, cell.traffic
    weights = fam.make_weights(cfg, cell.seed, cell.device)
    poses = poses_of(cell)
    pose_rays = {}
    rng = np.random.RandomState(cell.seed % 2**32)
    first = rng.randint(len(poses))
    H = W = t["size"]
    sel = []
    for i in range(frames):
        pi = (first + i) % len(poses)
        if pi not in pose_rays:
            pose_rays[pi] = fam.frame_rays(cfg, t, poses[pi])
        idx = rng.randint(H * W, size=t["check_pixels"])
        sel.append({"pose": pi, "idx": idx, "rays": {k: v[idx] for k, v in pose_rays[pi].items()}})
    got, state = fam.control_frames(weights, cfg, t, cell.seed, sel, lambda k: pose_rays[k], rounding("fp8"),
                                    cell.device)
    for fr, rgb in zip(sel, got):
        fr["rgb"] = rgb.cpu().numpy()
    return check(cell, weights, dict(state, frames=sel, pose_rays=lambda k: pose_rays[k]), info)
