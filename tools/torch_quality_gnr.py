"""GNR's quality row in the PyTorch port: train on the synthetic GeneBody rig,
evaluate a held-out camera and the reconstructed mesh against the known body
(the port's counterpart of ``tools/quality_gnr.py``).

    python tools/torch_quality_gnr.py [--iters 2000] [--size 256]
        [--n_rand 1024] [--chunk 8192] [--lr 1e-4] [--device cuda] [--seed 0]

``make_synthetic_genebody`` (one frame, an icosphere "person" of radius 0.3
seen by 8 cameras at ``--size`` squared); ``GeneBodyDataset`` conditions on
cameras 0-3, cameras 4-6 supervise, and camera 7 is never seen by the loss
and is the eval view. ``GnrNetwork`` with 4 views, 128 samples, 2 hourglass
stacks of 128, the 8x256 MLP with skips 2, 4, 6, from flax's init drawn from
``--seed``; Adam at ``--lr``. The held-out view is rendered in padded
``--chunk``-ray chunks (PSNR, SSIM). ``reconstruct_gnr`` meshes the density
at ``n_grid`` 64 (chunk 65,536, 2 smoothing passes) through the network's
density and colour queries on step 0's batch context, and the vertices'
distance from the body's centre is held against the radius 0.3.

Step i jitters its samples and noise under
``core/trainer.py:step_generator(seed, i)``. On the card ``configure_card``
runs first; without a card the tool raises unless ``--device cpu``. Prints
the JAX tool's JSON keys.
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
from xrnerf_torch.datasets.genebody import GeneBodyDataset  # noqa: E402
from xrnerf_torch.datasets.load.synthetic import make_synthetic_genebody  # noqa: E402
from xrnerf_torch.models.networks.gnr import GnrNetwork  # noqa: E402
from xrnerf_torch.models.renders.gnr_render import reconstruct_gnr  # noqa: E402
from xrnerf_torch.utils.device import configure_card, resolve_device  # noqa: E402
from xrnerf_torch.utils.metrics import mse2psnr, ssim  # noqa: E402

NETWORK = dict(num_views=4, n_samples=128, num_stack=2, num_hourglass=2, hourglass_dim=128, mlp_depth=8,
               mlp_width=256, skips=(2, 4, 6))
MESH = dict(n_grid=64, chunk=65536, laplacian=2)
RADIUS = 0.3  # make_synthetic_genebody's body
HELD_OUT = 7


def to_device(batch, device):
    return {k: torch.from_numpy(np.require(v, requirements="C")).to(device) for k, v in batch.items()}


def build(size, n_rand, device="cuda", seed=0):
    """(network, dataset, arrays): the JAX tool's configuration, flax's init
    from ``seed``; cameras 4-6 supervise, so the test pairs keep (0, 7)."""
    arrays = make_synthetic_genebody(n_frames=1, n_cams=8, H=size, W=size)
    ds = GeneBodyDataset(arrays=arrays, num_views=4, input_views=(0, 1, 2, 3), N_rand=n_rand)
    ds.query_views = [4, 5, 6]  # after construction: test_pairs still hold camera 7
    net = GnrNetwork(**NETWORK, load_size=size)
    net.to(device).reset_parameters(torch.Generator().manual_seed(seed))
    return net, ds, arrays


def train(net, ds, iters, lr, device="cuda", seed=0, step_gen=None, log_every=250):
    """``iters`` Adam steps. ``step_gen(i)`` gives step i's generator
    (``None``: no jitter, no noise). Returns (every step's loss, every
    step's train PSNR, seconds)."""
    dev = torch.device(device)
    if step_gen is None:
        step_gen = lambda i: step_generator(dev, seed, i)  # noqa: E731
    opt = torch.optim.Adam(net.parameters(), lr=lr)
    losses, psnrs = [], []
    t0 = time.perf_counter()
    for i in range(iters):
        batch = to_device(ds.train_batch(i), dev)
        loss, logs = net.loss(net(batch, generator=step_gen(i), train=True), batch)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        psnrs.append(logs["psnr"].detach())
        if log_every and i % log_every == 0:
            print(f"  iter {i}: loss {float(losses[-1]):.5f}", flush=True)
    losses, psnrs = [float(v) for v in losses], [float(p) for p in psnrs]  # after the run: the clock reads it done
    return losses, psnrs, time.perf_counter() - t0


def render(net, rays, device="cuda", chunk=8192):
    """rgb [n, 3] of one eval item: the rays in chunks (the last padded with
    rays from (0, 0, 0) to (1, 1, 1), as the JAX tool pads), the context
    keys whole in every chunk."""
    n = rays["rays_s"].shape[0]
    pad = (-n) % chunk
    ctx = to_device({k: v for k, v in rays.items() if k.startswith("ctx_")}, device)
    rs = np.concatenate([rays["rays_s"], np.zeros((pad, 3), np.float32)])
    re = np.concatenate([rays["rays_e"], np.ones((pad, 3), np.float32)])
    outs = []
    for s in range(0, n + pad, chunk):
        cb = dict(ctx, **to_device({"rays_s": rs[s:s + chunk], "rays_e": re[s:s + chunk]}, device))
        outs.append(net(cb, train=False)["rgb"].cpu().numpy())
    return np.concatenate(outs)[:n]


def evaluate(net, ds, device="cuda", chunk=8192):
    """PSNR and SSIM of the held-out camera's view."""
    rays, gt = ds.eval_item(ds.test_pairs.index((0, HELD_OUT)))
    img = render(net, rays, device, chunk).reshape(gt.shape)
    return float(mse2psnr(np.mean((img - gt) ** 2))), float(ssim(img, gt))


def mesh_error(net, ds, arrays, device="cuda", **mesh_kw):
    """``reconstruct_gnr`` through the network's queries on step 0's batch
    context, and the radial error of its vertices against the body: {} when
    the sweep finds no surface."""
    b0 = ds.train_batch(0)
    ctx = to_device(b0, device)
    verts, faces, _ = reconstruct_gnr(
        lambda p: net.query_density(ctx, p), lambda p, nrm: net.query_color(ctx, p, nrm),
        center=b0["ctx_center"], spatial_freq=float(b0["ctx_spatial_freq"]), load_size=net.load_size,
        device=device, **{**MESH, **mesh_kw},
    )
    if not len(verts):
        return {}
    r = np.linalg.norm(verts - np.asarray(arrays["smpl_verts"][0]).mean(0), axis=-1)
    return {
        "n_verts": int(len(verts)),
        "n_faces": int(len(faces)),
        "radius_mean": round(float(r.mean()), 4),
        "radius_mae_vs_0.3": round(float(np.abs(r - RADIUS).mean()), 4),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--n_rand", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)


    device = resolve_device(args.device)
    if device.type == "cuda":
        configure_card()
    net, ds, arrays = build(args.size, args.n_rand, device, args.seed)
    _, _, train_s = train(net, ds, args.iters, args.lr, device, args.seed)
    val_psnr, val_ssim = evaluate(net, ds, device, args.chunk)
    out = {
        "iters": args.iters,
        "train_seconds": round(train_s, 1),
        "held_out_view": HELD_OUT,
        "val_psnr": round(val_psnr, 2),
        "val_ssim": round(val_ssim, 4),
        "mesh": mesh_error(net, ds, arrays, device),
    }
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
