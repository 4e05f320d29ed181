#!/usr/bin/env python3
"""Probe of the port's full-width vanilla-NeRF train step on one CUDA card.

    python3 tools/torch_train_probe.py          # from the repo root

1. encodings A/B: the fused network's encode stage through its plain
   version (``ops/nerf_posenc.py:nerf_posenc_ref``, ``posenc_fast``'s chain
   of elementwise kernels) against the kernel (``nerf_posenc``, row 8).
   Checks that both give the same bits, then times the train step
   (``N_rand`` 4096, 64 + 128 samples, fused MLP) in the order plain,
   kernel, kernel, plain: with batches staged on the card before timing,
   and through ``Trainer.run`` with its prefetch thread.
2. host trace: three steady steps with staged batches under
   ``torch.profiler`` (CPU and CUDA activity): the host calls that take the
   most CPU time, the count of ``cudaStreamSynchronize`` and the ops each
   one ran inside.

Prints JSON lines; the card's name and power limit first. Needs a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402
import xrnerf_torch.models.networks.nerf as nerf_mod  # noqa: E402
from xrnerf_torch import build_network, load_config  # noqa: E402
from xrnerf_torch.core.trainer import Trainer  # noqa: E402
from xrnerf_torch.ops import build  # noqa: E402
from xrnerf_torch.ops.nerf_posenc import nerf_posenc, nerf_posenc_ref  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_train_probe: torch sees no CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    build.load_libraries(["fused_nerf_mlp_fwd", "fused_nerf_mlp_bwd", "nerf_posenc"])
    cfg = load_config(os.path.join(ROOT, "configs", "nerf", "nerf_blender.py"), dataname="lego")
    model_cfg = dict(cfg["model"], fused=True)
    ds = C.SphereScene(C.N_RAND, cfg["data"]["near"], cfg["data"]["far"])
    x = (torch.rand(4096, 192, 3, device="cuda") * 2 - 1) * 4
    d = torch.nn.functional.normalize(torch.randn(4096, 3, device="cuda"), dim=-1)
    same = all(torch.equal(a, b) for a, b in zip(nerf_posenc(x, d, 10, 4), nerf_posenc_ref(x, d, 10, 4)))
    if not same:
        raise AssertionError("the kernel's encodings differ from the plain version's bits")

    def trainer():
        return Trainer(build_network(model_cfg), ds, optimizer=cfg["optimizer"], work_dir=None,
                       max_iters=30, ckpt_interval=0, log_interval=10, device="cuda")

    runs = []
    for tag in ("plain", "kernel", "kernel", "plain"):
        nerf_mod.nerf_posenc = nerf_posenc_ref if tag == "plain" else nerf_posenc
        tr = trainer()
        batches = [tr._put_batch(ds.train_batch(s)) for s in range(13)]
        for s in range(3):
            tr.train_step(batches[s], s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(3, 13):
            tr.train_step(batches[s], s)
        torch.cuda.synchronize()
        staged = (time.perf_counter() - t0) / 10 * 1e3
        del batches
        rec = C.WindowLog()
        tr.hooks = [rec]
        tr.run()
        ms = [w["ms_per_step"] for w in rec.windows]
        runs.append({"posenc": tag, "staged_ms_per_step": staged, "run_window_ms_per_step": ms,
                     "run_ms_per_step": float(np.median(ms[1:]))})
        print(json.dumps(runs[-1]), flush=True)
        del tr
        torch.cuda.empty_cache()
    nerf_mod.nerf_posenc = nerf_posenc
    print(json.dumps({"phase": "posenc_ab", "bitwise_equal": same, "runs": runs}), flush=True)

    tr = trainer()
    batches = [tr._put_batch(ds.train_batch(s)) for s in range(8)]
    for s in range(5):
        tr.train_step(batches[s], s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for s in range(5, 8):
            tr.train_step(batches[s], s)
        torch.cuda.synchronize()
    ev = prof.key_averages()
    top = sorted(ev, key=lambda e: -e.self_cpu_time_total)[:10]
    syncs = sum(e.count for e in ev if e.key == "cudaStreamSynchronize")
    # which ops each sync ran inside (the innermost three, by time on its thread)
    events = list(prof.events())
    callers = {}
    for e in events:
        if e.name != "cudaStreamSynchronize":
            continue
        outer = [o for o in events if o is not e and o.thread == e.thread
                 and o.time_range.start <= e.time_range.start and o.time_range.end >= e.time_range.end]
        outer.sort(key=lambda o: o.time_range.end - o.time_range.start)
        key = " < ".join(o.name for o in outer[:3])
        callers[key] = callers.get(key, 0) + 1
    print(json.dumps({"phase": "host_trace", "steps": 3, "stream_syncs": syncs, "sync_callers": callers,
                      "top_self_cpu_ms": [[e.key[:60], e.self_cpu_time_total / 1e3, e.count] for e in top]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
