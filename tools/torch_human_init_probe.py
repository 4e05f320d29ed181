#!/usr/bin/env python3
"""NeuralBody and AniNeRF at the init a run gets, one CUDA card: which seeds start dead.

    python3 tools/torch_human_init_probe.py [--seeds 16]   # from the repo root

Builds ``configs/neuralbody/nb_zjumocap.py``'s and
``configs/aninerf/aninerf_zjumocap_train_pose.py``'s networks at full width
through ``Trainer`` (flax's init from ``seed``, as ``run_nerf`` gives it; no
density bias) on ``chip_smoke.py``'s seeded ZJU-like arrays, and for each
seed renders step 0's training batch (1,024 mask-weighted rays, the
deterministic path): the largest ``acc`` of the batch, its loss, the
gradient norm over all parameters and that of the density head's bias. A
seed whose ReLU density is below zero at every sample renders ``acc`` 0 and
gets no gradient through the density: it is printed as ``dead``.
Prints JSON lines, the card's name and power limit first. Needs a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, default=16, help="seeds 0 .. N-1")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch sees no CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0],
          flush=True)
    from xrnerf_torch import build_dataset, build_network, load_config
    from xrnerf_torch.core.trainer import Trainer
    from xrnerf_torch.utils.device import configure_card

    configure_card()
    arrays = C.ani_arrays()
    for name, cfg_path in (("neuralbody", ("neuralbody", "nb_zjumocap.py")),
                           ("aninerf", ("aninerf", "aninerf_zjumocap_train_pose.py"))):
        cfg = load_config(os.path.join(ROOT, "configs", *cfg_path), dataname="313")
        ds = build_dataset(dict(cfg["data"], datadir=None, arrays=arrays))
        bias = C.DENSITY_BIAS[name][0]
        dead = []
        for seed in range(args.seeds):
            tr = Trainer(build_network(cfg["model"], device="cuda"), ds, optimizer=cfg["optimizer"], work_dir=None,
                         max_iters=1, ckpt_interval=0, seed=seed, device="cuda")
            net = tr.network
            batch = tr._put_batch(ds.train_batch(0))
            out = net(batch, generator=None, train=True)
            loss = net.loss(out, batch)[0]
            loss.backward()
            acc_max = out["acc"].max().item()
            grads = [q.grad for q in net.parameters() if q.grad is not None]
            grad_norm = float(torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads])))
            bias_grad = float(torch.linalg.vector_norm(net.get_parameter(bias).grad))
            if acc_max == 0.0:
                dead.append(seed)
            C.emit({"phase": f"{name}_init", "seed": seed, "acc_max": acc_max, "loss": loss.item(),
                    "grad_norm": grad_norm, "density_bias_grad_norm": bias_grad, "dead": acc_max == 0.0})
            del tr, net, out, loss
            torch.cuda.empty_cache()
        C.emit({"phase": f"{name}_init_summary", "seeds": args.seeds, "dead_seeds": dead})
    return 0


if __name__ == "__main__":
    sys.exit(main())
