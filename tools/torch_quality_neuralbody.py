"""NeuralBody's quality row in the PyTorch port: train on the synthetic ZJU
rig, evaluate a held-out camera (the port's counterpart of
``tools/quality_neuralbody.py``).

    python tools/torch_quality_neuralbody.py [--iters 1500] [--size 256]
        [--n_rand 1024] [--chunk 8192] [--lr 5e-4] [--device cuda] [--seed 0]

``make_synthetic_zju`` (4 frames, 4 cameras at ``--size`` squared, 6,890
vertices); ``NeuralBodyDataset`` trains on cameras 0-2, so camera 3 of each
frame is never seen by the loss and is the eval view. ``NeuralBodyNetwork``
at its defaults with 4 frames, 64 samples, black background, from flax's init
drawn from ``--seed`` with no density bias; Adam at ``--lr`` (optax's
defaults otherwise). Eval renders every test pair in padded ``--chunk``-ray
chunks, the batch's context keys (vertices, frame index, box) whole in every
chunk.

Step i jitters its samples under ``core/trainer.py:step_generator(seed, i)``.
On the card ``configure_card`` runs first (TF32 off: the JAX tool's
``Conv3d`` stack is f32); without a card the tool raises unless ``--device
cpu``. Prints the JAX tool's JSON keys and ``step0_acc_max``, the largest
``acc`` of step 0's batch: a flax init can leave the ReLU density at or below
0 almost everywhere, and this says how far from dead the run started.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from xrnerf_torch.core.trainer import step_generator  # noqa: E402
from xrnerf_torch.datasets.load.synthetic import make_synthetic_zju  # noqa: E402
from xrnerf_torch.datasets.neuralbody import NeuralBodyDataset  # noqa: E402
from xrnerf_torch.models.networks.neuralbody import NeuralBodyNetwork  # noqa: E402
from xrnerf_torch.utils.device import configure_card, resolve_device  # noqa: E402
from xrnerf_torch.utils.metrics import mse2psnr, ssim  # noqa: E402

NETWORK = dict(num_frames=4, n_samples=64, white_bkgd=False)
RAY_KEYS = ("rays_o", "rays_d", "near", "far")


def to_device(batch, device):
    return {k: torch.from_numpy(np.require(v, requirements="C")).to(device) for k, v in batch.items()}


def build(size, n_rand, device="cuda", seed=0):
    """(network, dataset, arrays): the JAX tool's configuration, flax's init
    from ``seed``, no density bias."""
    arrays = make_synthetic_zju(n_frames=4, n_cams=4, H=size, W=size, n_verts=6890)
    ds = NeuralBodyDataset(arrays=arrays, N_rand=n_rand, training_view=(0, 1, 2))
    net = NeuralBodyNetwork(**NETWORK)
    net.to(device).reset_parameters(torch.Generator().manual_seed(seed))
    return net, ds, arrays


def train(net, ds, iters, lr, device="cuda", seed=0, step_gen=None, log_every=200):
    """``iters`` Adam steps. ``step_gen(i)`` gives step i's generator
    (``None`` samples deterministically). Returns (the last step's train
    PSNR, every step's PSNR, step 0's acc max, seconds)."""
    dev = torch.device(device)
    if step_gen is None:
        step_gen = lambda i: step_generator(dev, seed, i)  # noqa: E731
    opt = torch.optim.Adam(net.parameters(), lr=lr)
    psnrs, acc_max = [], None
    t0 = time.perf_counter()
    for i in range(iters):
        batch = to_device(ds.train_batch(i), dev)
        out = net(batch, generator=step_gen(i), train=True)
        loss, logs = net.loss(out, batch)
        if i == 0:
            acc_max = float(out["acc"].detach().max())
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        psnrs.append(logs["psnr"].detach())
        if log_every and i % log_every == 0:
            print(f"iter {i}: train psnr {float(psnrs[-1]):.2f}", flush=True)
    psnrs = [float(p) for p in psnrs]  # copied to the host after the run: the clock below reads a finished run
    return psnrs[-1], psnrs, acc_max, time.perf_counter() - t0


def render(net, rays, device="cuda", chunk=8192):
    """rgb [n, 3] of one eval item: the per-ray keys in chunks (the last
    padded with the last ray), the context keys whole in every chunk."""
    n = rays["rays_o"].shape[0]
    pad = (-n) % chunk
    ctx = to_device({k: v for k, v in rays.items() if k not in RAY_KEYS}, device)
    per_ray = {k: np.concatenate([rays[k], np.repeat(rays[k][-1:], pad, 0)]) if pad else rays[k] for k in RAY_KEYS}
    outs = []
    for s in range(0, n + pad, chunk):
        cb = dict(ctx, **to_device({k: v[s:s + chunk] for k, v in per_ray.items()}, device))
        outs.append(net(cb, train=False)["rgb"].cpu().numpy())
    return np.concatenate(outs)[:n]


def evaluate(net, ds, device="cuda", chunk=8192):
    """PSNR and SSIM of every test pair (the held-out camera of each frame)."""
    vp, vs = [], []
    for i, (frame, cam) in enumerate(ds.test_pairs):
        rays, gt = ds.eval_item(i)
        img = render(net, rays, device, chunk).reshape(gt.shape)
        vp.append(float(mse2psnr(np.mean((img - gt) ** 2))))
        vs.append(float(ssim(img, gt)))
        print(f"eval frame {frame} cam {cam}: psnr {vp[-1]:.2f}", flush=True)
    return vp, vs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=1500)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--n_rand", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)


    device = resolve_device(args.device)
    if device.type == "cuda":
        configure_card()
    net, ds, _ = build(args.size, args.n_rand, device, args.seed)
    psnr, _, acc_max, train_s = train(net, ds, args.iters, args.lr, device, args.seed)
    vp, vs = evaluate(net, ds, device, args.chunk)
    out = {
        "iters": args.iters,
        "train_psnr": round(psnr, 2),
        "train_seconds": round(train_s, 1),
        "heldout_cam_psnr": round(float(np.mean(vp)), 2) if vp else None,
        "heldout_cam_ssim": round(float(np.mean(vs)), 4) if vs else None,
        "n_eval_imgs": len(vp),
        "step0_acc_max": acc_max,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
