"""Micro-bench: KiloNeRF full-frame inference latency in the PyTorch port
(the port's counterpart of ``tools/bench_kilonerf.py``).

    python tools/torch_bench_kilonerf.py [--hw 800] [--chunk 65536]
        [--n_samples 384] [--n_keep 32] [--resolution 16]
        [--occupied_frac 0.15] [--frames 3] [--f32] [--device cuda]

The spatial-MoE multi-network (``KiloNerfNetwork``, ``resolution``^3
networks of 2 x 32, seeded flax-style init) renders one ``hw`` x ``hw``
frame chunk by chunk with occupancy-grid empty-space skipping: one frame is
``ceil(hw^2 / chunk)`` calls on the same seeded chunk of rays, synchronised
once at its end. The grid is a seeded ``[4R]^3`` random occupancy with
``occupied_frac`` occupied (the network's ``set_occupancy``: the port's
``KiloAux``). bf16 products by default (``dtype``), f32 with ``--f32``. The
rays and the grid are the JAX tool's draws (``RandomState(0)``). A pure
compute-path latency, not a quality claim. On the card ``configure_card``
runs first; without a card the tool raises unless ``--device cpu``. Prints
the card's name and power limit (``nvidia-smi``), then the JAX tool's line.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from xrnerf_torch.models.networks.kilonerf import KiloNerfNetwork  # noqa: E402
from xrnerf_torch.utils.device import card_line, configure_card, resolve_device  # noqa: E402


def draws(chunk: int, resolution: int, occupied_frac: float):
    """The JAX tool's draws, in its order: the chunk's rays (numpy) and the
    ``[4R]^3`` bool occupancy grid."""
    rng = np.random.RandomState(0)
    d = rng.randn(chunk, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    batch = {
        "rays_o": rng.randn(chunk, 3).astype(np.float32) * 0.1,
        "rays_d": d,
        "near": np.full((chunk, 1), 0.5, np.float32),
        "far": np.full((chunk, 1), 2.5, np.float32),
    }
    r4 = resolution * 4
    return batch, rng.rand(r4, r4, r4) < occupied_frac


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--hw", type=int, default=800)
    p.add_argument("--chunk", type=int, default=65536)
    p.add_argument("--n_samples", type=int, default=384)
    p.add_argument("--n_keep", type=int, default=32)
    p.add_argument("--resolution", type=int, default=16)
    p.add_argument("--occupied_frac", type=float, default=0.15)
    p.add_argument("--frames", type=int, default=3)
    p.add_argument("--f32", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        configure_card()
    print(card_line(device), flush=True)

    R = args.resolution
    net = KiloNerfNetwork(resolution=(R, R, R), hidden=32, n_hidden_layers=2, n_samples=args.n_samples,
                          n_keep=args.n_keep, dtype=torch.float32 if args.f32 else torch.bfloat16)
    net.reset_parameters(torch.Generator().manual_seed(0))
    net.to(device)
    HW, C = args.hw, args.chunk
    n_rays = HW * HW
    batch, occ = draws(C, R, args.occupied_frac)
    chunk_batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    net.set_occupancy(occ)

    # one frame = ceil(n_rays / C) chunk calls
    n_chunks = (n_rays + C - 1) // C

    def frame():
        acc = None
        for _ in range(n_chunks):
            acc = net(chunk_batch, train=False)["rgb"]
        return float(torch.sum(acc))  # waits for the chain

    frame()  # warm
    t0 = time.perf_counter()
    for _ in range(args.frames):
        frame()
    dt = (time.perf_counter() - t0) / args.frames
    rays_s = n_rays / dt
    print(
        f"kilonerf frame {HW}x{HW} ({R}^3 nets, {args.n_samples} cands, "
        f"keep {args.n_keep}, {'f32' if args.f32 else 'bf16'}, "
        f"{n_chunks} chunks of {C}): {dt*1e3:.2f} ms/frame  "
        f"{rays_s/1e6:.2f} Mrays/s  (reference GPU: 365-394 ms)",
        flush=True,
    )
    return dt


if __name__ == "__main__":
    main()
