"""Instant-NGP's synth24 quality row in the PyTorch port: vertex against brick
at the production table, trained to convergence (the port's counterpart of
``tools/quality_synth24.py``).

    python tools/torch_quality_synth24.py [--iters 4000] [--hw 320]
        [--layouts vertex,brick] [--batch 4096] [--device cuda] [--seed 0]

The scene is ``make_synthetic_blender``'s seeded sphere, 24 train and 2
held-out val views at ``--hw`` squared, written as PNGs and read back by
``HashNerfDataset``. The network is ``HashNerfNetwork`` at its defaults (16
levels, table 2^19, base 16 -> max_res 2048, grid 128^3, 512 candidates, keep
64), unfused as the JAX tool builds it, in the layout asked (``brick`` with 2
lattices). Adam 1e-2, beta2 0.99, eps 1e-15 (optax's form: torch's
denominator is also sqrt(v_hat) + eps); the grid is refreshed after every 16
steps, as the JAX tool's scan of 16 steps per dispatch does. The 2 val views
are rendered in padded 8,192-ray chunks: PSNR and SSIM.

Random streams: step i marches under ``core/trainer.py:step_generator(seed,
i)`` and the refresh after span d draws from ``(seed, 2**31 + 16 d)``; the
parameters start from flax's init drawn from ``--seed``. On the card
``configure_card`` runs first; without a card the tool raises unless
``--device cpu``. Prints one JSON line per layout, then the list, with the
JAX tool's keys.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from xrnerf_torch.core.trainer import step_generator  # noqa: E402
from xrnerf_torch.datasets.hashnerf import HashNerfDataset  # noqa: E402
from xrnerf_torch.datasets.load.synthetic import make_synthetic_blender  # noqa: E402
from xrnerf_torch.models.networks.hashnerf import HashNerfNetwork  # noqa: E402
from xrnerf_torch.utils.device import configure_card, resolve_device  # noqa: E402
from xrnerf_torch.utils.metrics import mse2psnr, ssim  # noqa: E402

SPAN = 16  # steps between grid refreshes: the JAX tool's scan length
EVAL_CHUNK = 8192  # rays per eval chunk, the last one padded with the last ray
NETWORK = {}  # HashNerfNetwork's defaults are the production table


def to_device(batch, device):
    return {k: torch.from_numpy(np.require(v, requirements="C")).to(device) for k, v in batch.items()}


def build(scene_dir, layout, batch, device="cuda", seed=0):
    """(network, dataset): the JAX tool's configuration, flax's init from
    ``seed``, the grid's untrained cells marked from the train cameras."""
    ds = HashNerfDataset(scene_dir, half_res=False, testskip=1, N_rand=batch)
    net = HashNerfNetwork(**NETWORK, hash_layout=layout, n_lattices=2 if layout == "brick" else 1, fused=False)
    net.to(device).reset_parameters(torch.Generator().manual_seed(seed))
    net.init_aux(ds)
    return net, ds


def train(net, ds, iters, device="cuda", seed=0, step_gen=None, refresh_draws=None, log_every=25, tag="",
          on_span=None):
    """``iters // SPAN`` spans of 16 Adam steps, each followed by a grid
    refresh. ``step_gen(i)`` gives step i's generator (``None`` marches
    deterministically) and ``refresh_draws(d)`` the refresh's ``GridDraws``
    (``None``: drawn from the refresh's own stream); ``on_span(d)`` runs
    after span d's refresh. Returns (the last step's train PSNR, the PSNR of
    every step, seconds)."""
    dev = torch.device(device)
    if step_gen is None:
        step_gen = lambda i: step_generator(dev, seed, i)  # noqa: E731
    opt = torch.optim.Adam(net.parameters(), lr=1e-2, betas=(0.9, 0.99), eps=1e-15)
    psnrs = []
    t0 = time.perf_counter()
    for d in range(iters // SPAN):
        for i in range(d * SPAN, (d + 1) * SPAN):
            batch = to_device(ds.train_batch(i), dev)
            loss, logs = net.loss(net(batch, generator=step_gen(i), train=True), batch)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            psnrs.append(logs["psnr"].detach())
        draws = refresh_draws(d) if refresh_draws is not None else None
        net.update_aux(None if draws is not None else step_generator(dev, seed, 2**31 + d * SPAN), draws=draws)
        if log_every and d % log_every == 0:
            print(f"  [{tag}] iter {d * SPAN}: train psnr {float(psnrs[-1]):.2f}", flush=True)
        if on_span is not None:
            on_span(d)
    psnrs = [float(p) for p in psnrs]  # copied to the host after the run: the clock below reads a finished run
    return psnrs[-1], psnrs, time.perf_counter() - t0


def render(net, rays, device="cuda", chunk=EVAL_CHUNK):
    """rgb [n, 3] of the rays, in chunks of ``chunk``; the last one padded
    by repeating the last ray, as the JAX tool pads."""
    n = rays["rays_o"].shape[0]
    pad = (-n) % chunk
    rays = {k: np.concatenate([v, np.repeat(v[-1:], pad, 0)]) if pad else v for k, v in rays.items()}
    outs = [net(to_device({k: v[s:s + chunk] for k, v in rays.items()}, device), train=False)["rgb"].float().cpu().numpy()
            for s in range(0, n + pad, chunk)]
    return np.concatenate(outs)[:n]


def evaluate(net, ds, device="cuda", chunk=EVAL_CHUNK):
    """PSNR and SSIM of each val view."""
    vp, vs = [], []
    for vi in ds.i_val:
        gt = ds.imgs[vi]
        img = render(net, ds.image_rays(vi), device, chunk).reshape(gt.shape)
        vp.append(float(mse2psnr(np.mean((img - gt) ** 2))))
        vs.append(float(ssim(img, gt)))
    return vp, vs


def run(scene_dir, layout, iters, batch, device="cuda", seed=0):
    net, ds = build(scene_dir, layout, batch, device, seed)
    train_psnr, _, train_s = train(net, ds, iters, device, seed, tag=layout)
    vp, vs = evaluate(net, ds, device)
    return {
        "layout": layout,
        "iters": iters,
        "train_psnr": round(train_psnr, 2),
        "val_psnr": round(float(np.mean(vp)), 2),
        "val_ssim": round(float(np.mean(vs)), 4),
        "train_seconds": round(train_s, 1),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--layouts", default="vertex,brick")
    ap.add_argument("--hw", type=int, default=320)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)


    device = resolve_device(args.device)
    if device.type == "cuda":
        configure_card()
    work = tempfile.mkdtemp(prefix="synth24_")
    scene = os.path.join(work, "scene")
    make_synthetic_blender(scene, n_train=24, n_val=2, n_test=2, H=args.hw, W=args.hw)
    results = []
    for k in args.layouts.split(","):
        print(f"=== {k}", flush=True)
        results.append(run(scene, k, args.iters, args.batch, device, args.seed))
        print(json.dumps(results[-1]), flush=True)
    print(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    main()
