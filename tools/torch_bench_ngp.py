"""Micro-bench: Instant-NGP training-step throughput in the PyTorch port (the
port's counterpart of ``tools/bench_ngp.py``).

    python tools/torch_bench_ngp.py [--batch 4096] [--n_keep 64]
        [--n_candidates 512] [--pallas] [--components] [--device cuda]

``train``: spans of 10 steps of ``HashNerfNetwork`` (forward, Huber loss,
backward, Adam 1e-2) on one seeded batch, two spans to warm up and five
timed, synchronised once at the end: ms/step and rays/s. ``--components``
times the pieces alone at ``batch x n_keep`` points (two warm-up calls, ten
timed, synchronised around them): the march (``march_rays`` through the
fresh grid), ``NGPField`` forward and forward + backward (``--pallas``: the
fused layout, kernel rows 3-6 on the card; the JAX tool's ``use_pallas``),
``HashEncoding`` forward and forward + backward (row 7 on the card). The
rays, targets and points are the JAX tool's draws (``RandomState(0)``);
parameters are flax's init from seed 0. On the card ``configure_card`` runs
first; without a card the tool raises unless ``--device cpu``. Prints the
card's name and power limit (``nvidia-smi``), then the JAX tool's lines.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from xrnerf_torch.core.trainer import step_generator  # noqa: E402
from xrnerf_torch.models.embedders.hashenc import HashEncoding  # noqa: E402
from xrnerf_torch.models.fields.ngp_mlp import NGPField  # noqa: E402
from xrnerf_torch.models.networks.hashnerf import HashNerfNetwork  # noqa: E402
from xrnerf_torch.models.samplers.ngp_march import march_rays  # noqa: E402
from xrnerf_torch.utils.device import card_line, configure_card, resolve_device  # noqa: E402

STEPS = 10  # steps per timed span, the JAX tool's scan length


def draws(batch: int, n_keep: int):
    """The JAX tool's draws, in its order: the batch (numpy) and the
    components' points and directions."""
    rng = np.random.RandomState(0)
    d = rng.randn(batch, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    b = {
        "rays_o": rng.rand(batch, 3).astype(np.float32) * 0.2 + 0.1,
        "rays_d": d,
        "target": rng.rand(batch, 3).astype(np.float32),
    }
    n_pts = batch * n_keep
    pts = rng.rand(n_pts, 3).astype(np.float32)
    dirs = np.tile(d, (n_keep, 1))[:n_pts]
    return b, pts, dirs


def timed(fn, device, n=5, warmup=2):
    """Seconds per call of ``fn()``, the card synchronised around the timed calls."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / n


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--n_keep", type=int, default=64)
    p.add_argument("--n_candidates", type=int, default=512)
    p.add_argument("--pallas", action="store_true")
    p.add_argument("--components", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        configure_card()
    print(card_line(device), flush=True)

    B = args.batch
    b, pts_np, dirs_np = draws(B, args.n_keep)
    batch = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
    net = HashNerfNetwork(n_candidates=args.n_candidates, n_keep=args.n_keep).to(device)
    net.reset_parameters(torch.Generator().manual_seed(0))
    net.init_aux()
    opt = torch.optim.Adam(net.parameters(), lr=1e-2)
    step = [0]

    def span():
        loss = None
        for _ in range(STEPS):
            loss = net.loss(net(batch, generator=step_generator(device, 0, step[0]), train=True), batch)[0]
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            step[0] += 1
        return loss

    for _ in range(2):
        span()
    t0 = time.perf_counter()
    for _ in range(5):
        loss = span()
    float(loss.detach())  # waits for the last step
    dt = (time.perf_counter() - t0) / 5
    print(f"train: {dt*1e3/STEPS:.2f} ms/step  {B * STEPS / dt:,.0f} rays/s", flush=True)

    if args.components:
        gen = torch.Generator(device).manual_seed(0)

        def do_march():
            return march_rays(gen, batch["rays_o"], batch["rays_d"], net.grid,
                              n_candidates=args.n_candidates, n_keep=args.n_keep)

        with torch.inference_mode():
            dt = timed(do_march, device, n=10)
        print(f"march: {dt*1e3:.2f} ms", flush=True)

        n_pts = B * args.n_keep
        pts, dirs = torch.from_numpy(pts_np).to(device), torch.from_numpy(dirs_np).to(device)
        field = NGPField(fused=args.pallas).to(device)
        field.reset_parameters(torch.Generator().manual_seed(0))

        def fwd():
            rgb, sig = field(pts, dirs)
            return torch.sum(rgb) + torch.sum(sig)

        def fwdbwd():
            field.zero_grad(set_to_none=True)
            fwd().backward()

        with torch.inference_mode():
            dt = timed(fwd, device, n=10)
        print(f"field fwd ({n_pts} pts): {dt*1e3:.2f} ms  {n_pts/dt/1e6:.1f} Mpts/s", flush=True)
        dt = timed(fwdbwd, device, n=10)
        print(f"field fwd+bwd: {dt*1e3:.2f} ms  {n_pts/dt/1e6:.1f} Mpts/s", flush=True)

        enc = HashEncoding().to(device)
        enc.reset_parameters(torch.Generator().manual_seed(0))

        def enc_fwd():
            return torch.sum(enc(pts))

        def enc_bwd():
            enc.zero_grad(set_to_none=True)
            enc_fwd().backward()

        with torch.inference_mode():
            dt = timed(enc_fwd, device, n=10)
        print(f"hashenc fwd: {dt*1e3:.2f} ms  {n_pts/dt/1e6:.1f} Mpts/s", flush=True)
        dt = timed(enc_bwd, device, n=10)
        print(f"hashenc fwd+bwd: {dt*1e3:.2f} ms  {n_pts/dt/1e6:.1f} Mpts/s", flush=True)


if __name__ == "__main__":
    main()
