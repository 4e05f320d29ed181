#!/usr/bin/env python3
"""synth24's held-out PSNR along a run, with row 7's kernel or its plain version, on one CUDA card.

    python3 tools/torch_quality_probe.py [--layouts brick] [--seeds 0] [--every 1000] [--scatter kernel,plain]

Builds the scene and the network through ``tools/torch_quality_synth24.py`` and trains as that tool does (its
``train``), and every ``--every`` steps renders the two val views (PSNR and SSIM per view, the grid's occupied
share). ``--scatter plain`` sends the hash encodings' backward through ``scatter_add_rows_levels_plain``
(``index_add_`` on the card) in place of ``csrc/scatter_rows.cu``, so runs with and without the kernel stand side by
side; the kernel's launches are counted either way. Prints the card's name and power limit, then one JSON line per
evaluation and one per run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--layouts", default="brick")
    p.add_argument("--seeds", default="0")
    p.add_argument("--iters", type=int, default=4000)
    p.add_argument("--every", type=int, default=1000)
    p.add_argument("--scatter", default="kernel,plain")
    p.add_argument("--hw", type=int, default=320)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch sees no CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0],
          flush=True)
    import chip_smoke as C
    from xrnerf_torch.datasets.load.synthetic import make_synthetic_blender
    from xrnerf_torch.models.embedders import hashenc
    from xrnerf_torch.ops import scatter_rows
    from xrnerf_torch.utils.device import configure_card

    configure_card()
    tool = C.quality_tool("synth24")
    scene = make_synthetic_blender(os.path.join(tempfile.mkdtemp(), "scene"), n_train=24, n_val=2, n_test=2,
                                   H=args.hw, W=args.hw)
    kernel = hashenc.scatter_add_rows_levels
    for layout in args.layouts.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            for scatter in args.scatter.split(","):
                hashenc.scatter_add_rows_levels = kernel if scatter == "kernel" else \
                    scatter_rows.scatter_add_rows_levels_plain
                scatter_rows.scatter_add_rows_levels.launches = 0
                net, ds = tool.build(scene, layout, 4096, "cuda", seed)
                t0 = time.perf_counter()

                def on_span(d):
                    step = (d + 1) * tool.SPAN
                    if step % args.every == 0:
                        vp, vs = tool.evaluate(net, ds, "cuda")
                        C.emit({"layout": layout, "seed": seed, "scatter": scatter, "step": step,
                                "val_psnr": vp, "val_ssim": vs,
                                "occupied": float(net.grid_bitfield.float().mean()),
                                "seconds": time.perf_counter() - t0})

                train_psnr, _, train_s = tool.train(net, ds, args.iters, "cuda", seed, log_every=0, on_span=on_span)
                C.emit({"layout": layout, "seed": seed, "scatter": scatter, "train_psnr": train_psnr,
                        "train_seconds": train_s, "kernel_launches": scatter_rows.scatter_add_rows_levels.launches})
                del net, ds
                torch.cuda.empty_cache()
    hashenc.scatter_add_rows_levels = kernel
    return 0


if __name__ == "__main__":
    sys.exit(main())
