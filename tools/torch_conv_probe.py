#!/usr/bin/env python3
"""NeuralBody's conv stack on one CUDA card, with cuDNN's algorithm search off and on.

    python3 tools/torch_conv_probe.py            # from the repo root

Builds ``configs/neuralbody/nb_zjumocap.py``'s network at full width (96^3
grid, 4 x 32 conv widths, f32, TF32 off) on ``chip_smoke.py``'s seeded
ZJU-like arrays and times one ``Trainer.train_step`` (CUDA events, median of
5) and the device time of its convolutions by direction (forward, data
gradient, weight gradient; torch.profiler), with
``torch.backends.cudnn.benchmark`` off (cuDNN's heuristic picks each
algorithm) and on (cuDNN times its algorithms for each shape once and keeps
the fastest; ``utils.device.configure_card``'s setting). PyTorch keeps
a shape's plan whichever way it was chosen, so each setting runs in a
process of its own, in turns off, on, on, off.
Prints JSON lines, the card's name and power limit first. Needs a card.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402


def conv_directions(by_kernel):
    """Device ms of the step's convolutions: forward, data and weight gradients."""
    out = {"fprop": 0.0, "dgrad": 0.0, "wgrad": 0.0}
    for name, ms, _ in by_kernel:
        low = name.lower()
        if not C.is_conv(name):
            continue
        key = "wgrad" if "wgrad" in low else "dgrad" if "dgrad" in low else "fprop"
        out[key] += ms
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch sees no CUDA card", file=sys.stderr)
        return 2
    if sys.argv[1:] != ["--one"]:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0],
              flush=True)
        for benchmark in ("0", "1", "1", "0"):
            subprocess.run([sys.executable, os.path.abspath(__file__), "--one"], check=True, timeout=600,
                           env=dict(os.environ, CUDNN_SEARCH=benchmark))
        return 0
    from xrnerf_torch import build_dataset, build_network, load_config
    from xrnerf_torch.core.trainer import Trainer
    from xrnerf_torch.utils.device import configure_card

    configure_card()
    torch.backends.cudnn.benchmark = os.environ["CUDNN_SEARCH"] == "1"  # configure_card's setting is on

    cfg = load_config(os.path.join(ROOT, "configs", "neuralbody", "nb_zjumocap.py"), dataname="313")
    ds = build_dataset(dict(cfg["data"], datadir=None, arrays=C.ani_arrays()))
    tr = Trainer(build_network(cfg["model"], device="cuda"), ds, optimizer=cfg["optimizer"], work_dir=None,
                 max_iters=1, ckpt_interval=0, seed=C.SEED, device="cuda")
    name, value = C.DENSITY_BIAS["neuralbody"]
    with torch.no_grad():
        tr.network.get_parameter(name).fill_(value)
    batch = tr._put_batch(ds.train_batch(0))
    t0 = time.perf_counter()
    tr.train_step(batch, 0)  # with the search on, the first call of each shape times its algorithms
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    step_ms = C.time_ms(lambda: tr.train_step(batch, 0), reps=5, warmup=1)
    by_kernel, _ = C.device_times(lambda: tr.train_step(batch, 0))
    C.emit({"phase": "nb_conv", "cudnn_benchmark": torch.backends.cudnn.benchmark, "first_step_ms": first_ms,
            "step_ms": step_ms, "device_busy_ms": sum(ms for _, ms, _ in by_kernel),
            "conv_ms": conv_directions(by_kernel),
            "conv_kernels": [(k[:90], ms, n) for k, ms, n in by_kernel if C.is_conv(k)][:8]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
