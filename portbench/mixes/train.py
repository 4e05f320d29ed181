"""Training traffic on a pooled scene: the port's ``SceneDataset`` over
blender files (``lib/scene.py``), in its pooled mode, trained by
``Trainer.run`` with its prefetcher; a hook of the benchmark's watches the
steps and asks the loop to stop when the window ends.

Set-up builds one Trainer, loads the benchmark's weights into it and runs
its first ``warmup_steps`` steps through ``Trainer.run``; the window opens
on a synchronize after them and closes on one after the step that crosses
``seconds``. ``train_rays_per_s`` is every ray of the window's steps over the
window.

The check follows the first three steps (``FOLLOWED``) of that same object:
each step's loss, the first gradient as Adam got it (its first moment over
1 - beta1 after one step) and the change of the parameters after three
steps, against the reference's three steps on the same rays and draws. Each
is compared by its worst gap (``common.leaf_gap``), leaves whose reference
gradient is under a thousandth of the median leaf's left out.
"""

from __future__ import annotations

import gc
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ..lib import rays as lrays
from ..lib import scene as lscene
from ..reference.lowp import rounding
from .common import Cell, RunRecord, leaf_gap, norms, now, sync, traced_slices, wrap_layers

FOLLOWED = 3
NEGLIGIBLE = 1e-3


class TimedDataset:
    """The dataset as the Trainer sees it, with the host time of every
    ``train_batch`` call (run in the prefetch thread) kept per step."""

    def __init__(self, dataset):
        self._dataset = dataset
        self.batch_s: Dict[int, float] = {}

    def train_batch(self, step, *args, **kw):
        t0 = now()
        out = self._dataset.train_batch(step, *args, **kw)
        self.batch_s[step] = now() - t0
        return out

    def __getattr__(self, name):
        return getattr(self._dataset, name)


class Window:
    """The Trainer hook: records what the check follows, opens and closes
    the window, and runs the traced slice."""

    def __init__(self, cell: Cell, names: Dict[int, str]):
        t = cell.traffic
        self.cell, self.names = cell, names
        self.warmup = t["warmup_steps"]
        self.slices = traced_slices(cell.device, self.warmup + t["trace_after"], t["trace_steps"]) if cell.trace else []
        self.losses: List[torch.Tensor] = []
        self.first_grad = self.after = None
        self.bad = None
        self.t_open = self.t_close = None
        self.window_steps = 0

    def on_run_begin(self, tr): ...

    def on_eval(self, tr, step): ...

    def on_run_end(self, tr): ...

    def after_step(self, tr, step, logs):
        dev = self.cell.device
        if step <= FOLLOWED:
            self.losses.append(logs["loss"].detach().clone())
        if step == 1:  # Adam's first moment after one step is (1 - beta1) g
            beta1 = tr.optimizer.param_groups[0]["betas"][0]
            self.first_grad = {self.names[id(p)]: (st["exp_avg"] / (1 - beta1)).clone()
                               for p, st in tr.optimizer.state.items()}
        if step == FOLLOWED:
            self.after = {n: p.detach().clone() for n, p in tr.network.named_parameters()}
        if step == self.warmup:
            sync(dev)
            self.t_open = now()
            self.bad = torch.zeros((), dtype=torch.int64, device=logs["loss"].device)
            return
        if self.t_open is None:
            return
        self.bad += (~torch.isfinite(logs["loss"])).long()
        for _, end, sl in self.slices:
            if step == end:
                sl.stop()
        for begin, _, sl in self.slices:
            if step == begin:
                sl.start()
        if now() - self.t_open >= self.cell.seconds and all(sl.events is not None for _, _, sl in self.slices):
            tr.request_stop()
            sync(dev)
            self.t_close = now()
            self.window_steps = step - self.warmup


def load_scene(cell: Cell):
    """(scene directory, the port's dataset, its seconds) for the cell."""
    from xrnerf_torch import build_dataset

    t, cfg = cell.traffic, cell.cfg
    scene_dir = lscene.blender_scene(t["scene"], cell.cache_root)
    ds = build_dataset(dict(type="SceneDataset", datadir=scene_dir, dataset_type="blender", half_res=False,
                            testskip=1, white_bkgd=cfg["white_bkgd"], N_rand=t["N_rand"], batching=t["batching"],
                            precrop_iters=t["precrop_iters"], near=cfg["near"], far=cfg["far"],
                            seed=cell.seed % 2**32))
    return scene_dir, ds


def run(cell: Cell) -> RunRecord:
    from xrnerf_torch.core.trainer import Trainer

    rec = RunRecord(cell)
    cfg, fam = cell.cfg, cell.family
    t0 = now()
    scene_dir, ds = load_scene(cell)
    rec.info["scene_and_pool_s"] = now() - t0
    timed = TimedDataset(ds)
    net = fam.build(cfg, cell.device)
    names = {id(p): n for n, p in net.named_parameters()}
    hook = Window(cell, names)
    tr = Trainer(net, timed, optimizer=cfg["optimizer"], work_dir=None, max_iters=10**12, eval_interval=0,
                 ckpt_interval=0, log_interval=10**12, hooks=[hook], seed=cell.seed, eval_chunk=cfg["eval_chunk"],
                 device=cell.device)
    weights = fam.make_weights(cfg, cell.seed, cell.device)
    fam.load(tr.network, weights)
    if cell.trace:
        wrap_layers(fam.layer_modules(tr.network))
    tr.run()

    window_s = hook.t_close - hook.t_open
    n_rand = cell.traffic["N_rand"]
    rec.attempted = hook.window_steps
    rec.failed = int(hook.bad)
    rec.end_to_end = {"setup_s": hook.t_open - cell.t_start,
                      "train_rays_per_s": hook.window_steps * n_rand / window_s}
    steps = range(cell.traffic["warmup_steps"], cell.traffic["warmup_steps"] + hook.window_steps)
    batch_s = [timed.batch_s[s] for s in steps if s in timed.batch_s]
    rec.counters = {"window_s": window_s, "window_steps": hook.window_steps, "rays_per_step": n_rand,
                    "batch_host_ms": 1e3 * sum(batch_s) / max(len(batch_s), 1),
                    "slice_steps": cell.traffic["trace_steps"]}
    if hook.slices:
        rec.summary, rec.idle = (sl.summary(fam.LAYERS) for _, _, sl in hook.slices)
    rec.memory_peak_bytes = torch.cuda.max_memory_allocated() if torch.device(cell.device).type == "cuda" else 0
    served = {"losses": [float(x) for x in hook.losses[:FOLLOWED]], "first": norms(hook.first_grad),
              "change": norms({k: hook.after[k] - weights[k] for k in weights})}
    del tr, net, hook, timed, ds
    gc.collect()
    if torch.device(cell.device).type == "cuda":
        torch.cuda.empty_cache()
    rec.checks = check(cell, weights, served)
    rec.info["leaves_left_out"] = served["left_out"]
    return rec


def followed_inputs(cell: Cell, device):
    """The rays, targets and draws of the first ``FOLLOWED`` steps, worked
    out again from the scene's files and the seed: the pooled batch of step
    k is rows [k N, (k + 1) N) (mod the pool less one batch) of a seeded
    permutation of every pixel of the training views, in view order."""
    t, cfg = cell.traffic, cell.cfg
    sc = t["scene"]
    H = W = sc["size"]
    K = lrays.intrinsics(H, W, lrays.focal_of(W, sc["camera_angle_x"]))
    poses = lscene.scene_poses(sc)
    scene_dir = lscene.blender_scene(sc, cell.cache_root)
    n_pool, N = len(poses) * H * W, t["N_rand"]
    perm = np.random.RandomState(cell.seed % 2**32).permutation(n_pool)
    images = {}
    batches, draws = [], []
    for k in range(FOLLOWED):
        start = (k * N) % max(n_pool - N, 1)
        idx = perm[start:start + N]
        view, pix = np.divmod(idx, H * W)
        o = np.empty((N, 3), np.float32)
        d = np.empty((N, 3), np.float32)
        target = np.empty((N, 3), np.float32)
        for v in np.unique(view):
            sel = view == v
            row, col = np.divmod(pix[sel], W)
            o[sel], d[sel] = lrays.pixel_rays(K, poses[v], row, col)
            if v not in images:
                images[v] = lscene.read_png(f"{scene_dir}/train/r_{v}.png").reshape(-1, 4)
            rgba = images[v][pix[sel]].astype(np.float64) / 255.0
            target[sel] = (rgba[:, :3] * rgba[:, 3:] + (1.0 - rgba[:, 3:])).astype(np.float32)
        to = {"rays_o": o, "rays_d": d, "target": target,
              "near": np.full((N, 1), cfg["near"], np.float32), "far": np.full((N, 1), cfg["far"], np.float32)}
        batches.append({key: torch.from_numpy(v).to(device) for key, v in to.items()})
        g = torch.Generator(device=device).manual_seed(cell.seed * 2**32 + k)
        m = cfg["model"]
        draws.append((torch.rand((N, m["n_samples"]), generator=g, device=device),
                      torch.rand((N, m["n_importance"]), generator=g, device=device)))
    return batches, draws


def reference_steps(cell: Cell, weights, precision: str, rows: Optional[int] = None):
    """(losses, first gradient's norms, change's norms) of the reference's
    ``FOLLOWED`` steps in ``precision``; with ``rows``, the loss of each step
    over its first ``rows`` rays alone (a fault: the rest of the batch left
    out, the mean over what is left)."""
    from ..reference import nerf as ref

    batches, draws = followed_inputs(cell, cell.device)
    if rows is not None:
        batches = [{k: v[:rows] for k, v in b.items()} for b in batches]
        draws = [(a[:rows], b[:rows]) for a, b in draws]
    losses, first, after = ref.train(weights, cell.cfg, batches, draws, cell.traffic["reference_block"],
                                     rounding(precision))
    return {"losses": losses, "first": norms(first), "change": norms({k: after[k] - weights[k] for k in weights})}


def check(cell: Cell, weights, served: Dict) -> Dict[str, float]:
    """The gaps between ``served`` (the port's three steps) and the
    reference's."""
    want = reference_steps(cell, weights, "float32")
    median = sorted(want["first"].values())[len(want["first"]) // 2]
    skip = {k for k, v in want["first"].items() if v < NEGLIGIBLE * median}
    served["left_out"] = sorted(skip)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(served["losses"], want["losses"]))
    if not all(math.isfinite(x) for x in served["losses"]):
        loss_gap = math.inf
    return {"loss_gap": loss_gap, "grad_gap": leaf_gap(served["first"], want["first"], skip),
            "change_gap": leaf_gap(served["change"], want["change"], skip)}


def control(cell: Cell, precision: str = "fp8") -> Dict[str, float]:
    """The check with the reference computed in ``precision`` in the port's
    place: ``fp8`` (the forward's and the backward's products) or
    ``fp8_backward`` (the backward's alone)."""
    weights = cell.family.make_weights(cell.cfg, cell.seed, cell.device)
    return check(cell, weights, reference_steps(cell, weights, precision))


def fault_half_batch(cell: Cell) -> Dict[str, float]:
    """The check with the reference in the port's place and half of each
    batch left out of its loss."""
    weights = cell.family.make_weights(cell.cfg, cell.seed, cell.device)
    return check(cell, weights, reference_steps(cell, weights, "float32", cell.traffic["N_rand"] // 2))
