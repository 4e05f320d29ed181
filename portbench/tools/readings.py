#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, on the card:

    python3 portbench/tools/readings.py --workload <cell> --seeds 101,102,... \\
        [--control-seeds 201,202,203] [--control-precision fp8] [--fault-seeds 301,302,303] \\
        [--seconds 3] [--frames 40]

For each of ``--seeds`` a whole run of the cell (set-up, a window of
``--seconds``, the check) in this one process, and for each of
``--control-seeds`` the check with the reference computed in fp8 in the
port's place (``mixes/<kind>.py:control``; a render cell's on ``--frames``
frames; a training cell's in ``--control-precision``: ``fp8``, forward and
backward, or ``fp8_backward``), and for each of ``--fault-seeds`` of a training cell the check of
the reference with half of each batch left out of its loss
(``mixes/train.py:fault_half_batch``). One JSON line per reading:
``{"kind": "program" | "control" | "fault_half_batch", "seed", "checks",
...}``. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--control-precision", default="fp8")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--frames", type=int, default=40)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    from xrnerf_torch.utils.device import configure_card

    configure_card()
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        rec, line = run.run_cell(args.workload, seed, args.seconds, False)
        print(json.dumps({"kind": "program", "seed": seed, "checks": rec.checks, "correct": line["correct"],
                          "attempted": rec.attempted, "metrics": line["metrics"], "info": rec.info,
                          "s": time.perf_counter() - t0}), flush=True)
        del rec, line
        gc.collect()
        torch.cuda.empty_cache()
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t0 = time.perf_counter()
        cell = run.make_cell(args.workload, seed, args.seconds, False)
        drv = run.mix_of(cell)
        info = {}
        if cell.traffic["kind"] == "train":
            checks, info["precision"] = drv.control(cell, args.control_precision), args.control_precision
        else:
            checks = drv.control(cell, args.frames, info)
        print(json.dumps({"kind": "control", "seed": seed, "checks": checks, "info": info,
                          "s": time.perf_counter() - t0}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    for seed in [int(s) for s in args.fault_seeds.split(",") if s]:
        t0 = time.perf_counter()
        cell = run.make_cell(args.workload, seed, args.seconds, False)
        checks = run.mix_of(cell).fault_half_batch(cell)
        print(json.dumps({"kind": "fault_half_batch", "seed": seed, "checks": checks, "s": time.perf_counter() - t0}),
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
