#!/usr/bin/env python3
"""A cell's traced run with the program's own spans read out, on the card:

    python3 portbench/tools/spans.py --workload <cell> --seeds 101,102 [--seconds 30]

For each seed a whole traced run of the cell (as ``run.py --trace 1``) in
this one process; its host-op slice's summary carries the program's spans
(``lib/program.py``). One JSON line per run: the run's result line
(``line``), and per traced step or frame (``per``) each ``xrnerf_torch.*``
span's count, its host and device ms, and the idle ms with the host in it
and after its operations; ``covered``, the spans' share
of the slice's device time; ``mlp_minus_layer_ms``, the device time of
``xrnerf_torch.nerf.mlp`` less that of the benchmark's own span around
``NerfMLP.forward`` (0 when both read the same operations); and the idle ms
in no span against the breakdown's ``host:no_op``. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from typing import Dict, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench import run  # noqa: E402
from portbench.lib import program  # noqa: E402


def traced(workload: str, seed: int, seconds: float, device: str = "cuda", overrides: Optional[Dict] = None,
           cache_root: Optional[str] = None):
    """(the run's record, its result line, the program's spans of its
    host-op slice or None)."""
    rec, line = run.run_cell(workload, seed, seconds, True, device, overrides=overrides, cache_root=cache_root)
    return rec, line, rec.summary.program if rec.summary is not None else None


def per_unit(rec, spans: program.ProgramSpans) -> Dict:
    units = program.units(rec)
    ms = 1e3 / units
    s = rec.summary
    mlp = spans.spans.get("xrnerf_torch.nerf.mlp", {}).get("device_s", 0.0)
    idle_in = sum(v["idle_s"] for v in spans.spans.values())
    return {
        "spans": {name: {"count": v["count"] / units, "host_ms": v["host_s"] * ms, "device_ms": v["device_s"] * ms,
                         "idle_ms": v["idle_s"] * ms, "idle_after_ms": v["idle_after_s"] * ms}
                  for name, v in sorted(spans.spans.items())},
        "device_ms": spans.device_s * ms,
        "covered": sum(v["device_s"] for v in spans.spans.values()) / spans.device_s,
        "mlp_minus_layer_ms": (mlp - s.layer_device_s.get("nerf_mlp", 0.0)) * ms,
        "idle_outside_spans_ms": (spans.idle_s - idle_in) * ms,
        "host_no_op_ms": dict(s.idle_gaps).get("host:no_op", 0.0) * ms,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("spans: no CUDA card", file=sys.stderr)
        return 2
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        rec, line, spans = traced(args.workload, seed, args.seconds)
        print(json.dumps({"seed": seed, "line": line, "per": per_unit(rec, spans) if spans is not None else None,
                          "s": time.perf_counter() - t0}), flush=True)
        del rec, line, spans
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
