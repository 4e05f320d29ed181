#!/usr/bin/env python3
"""One run of one cell of the port's benchmark, on the card of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's entry in ``BENCHMARK.json`` names
its configuration (``portbench/configs/<config>.json``) and traffic
(``portbench/traffic/<traffic>.json``); ``portbench/limits/<cell>.json``
holds the limits of its correctness check. The last line of standard output
is one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``: each
number compared beside its limit); the last lines of standard error repeat
the checks. Without a CUDA card, or with fewer than the cell asks for, it
exits 2 and prints no result; it exits 3 without a result if JAX or the JAX
package is loaded once the window has closed.

Caches live at fixed paths inside the checkout (``.portbench_cache/``: the
training scene's files); the port's kernels build into its own
``xrnerf_torch/_build/``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "xrnerf_tpu")
CACHE = ".portbench_cache"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: ``xrnerf_torch`` is not ``xrnerf_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_benchmark(root: str) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_entries(bench: Dict, workload: str):
    """(workload entry, config entry, traffic data, config data)."""
    wl = {w["name"]: w for w in bench["workloads"]}
    if workload not in wl:
        raise SystemExit(f"unknown workload {workload!r}; the benchmark has {sorted(wl)}")
    w = wl[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "portbench", "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    return w, conf, traffic, cfg


def reported(metrics: List[Dict], workload: str, end_to_end: List[Dict]) -> List[Dict]:
    """The metrics a cell reports: those that list it, or, without a list,
    every end-to-end metric and every per-layer metric whose end-to-end
    metric the cell reports."""
    mine = {m["name"] for m in end_to_end if workload in m.get("workloads", [workload])}
    out = []
    for m in metrics:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif m.get("moves", m["name"]) in mine:
            out.append(m)
    return out


def load_reader(name: str):
    """The reader of a per-layer metric: ``metrics/<name>.py``, or for a
    name ``a.b.c`` with no file of its own that of ``a.b``, then ``a``."""
    parts = name.split(".")
    for k in range(len(parts), 0, -1):
        path = os.path.join(ROOT, "portbench", "metrics", ".".join(parts[:k]) + ".py")
        if os.path.exists(path):
            break
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def make_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
              bench: Optional[Dict] = None, overrides: Optional[Dict] = None, cache_root: Optional[str] = None):
    """The cell's inputs, read from its files by name."""
    from portbench.mixes.common import Cell

    bench = bench or load_benchmark(ROOT)
    w, conf, traffic, cfg = cell_entries(bench, workload)
    for key, part in (overrides or {}).items():  # tests cut the sizes here
        {"cfg": cfg, "traffic": traffic}[key].update(part)
    with open(os.path.join(ROOT, "portbench", "limits", f"{workload}.json")) as f:
        limits = json.load(f)["limits"]
    family = importlib.import_module(f"portbench.families.{cfg['family']}")
    return Cell(workload, cfg, traffic, family, limits, seed, seconds, trace, device,
                cache_root or os.path.join(ROOT, CACHE), T_START)


def mix_of(cell):
    return importlib.import_module(f"portbench.mixes.{cell.traffic['kind']}")


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             bench: Optional[Dict] = None, overrides: Optional[Dict] = None, cache_root: Optional[str] = None):
    """Build, warm up, measure and check one cell; returns (the run's
    record, its result line as a dict)."""
    bench = bench or load_benchmark(ROOT)
    cell = make_cell(workload, seed, seconds, trace, device, bench, overrides, cache_root)
    if device == "cuda":
        from xrnerf_torch.utils.device import configure_card

        configure_card()
    rec = mix_of(cell).run(cell)
    return rec, result_line(rec, bench, trace)


def result_line(rec, bench: Dict, trace: bool) -> Dict:
    import torch

    name = rec.cell.name
    metrics = {}
    if not trace:
        for m in reported(bench["end_to_end"], name, bench["end_to_end"]):
            key = m["name"] if m["name"] in rec.end_to_end else m["name"].split(".")[0]
            if key in rec.end_to_end:  # frame_ms.ngp is the run's frame_ms
                metrics[m["name"]] = {"value": rec.end_to_end[key], "unit": m["unit"]}
    else:
        for m in reported(bench["per_layer"], name, bench["end_to_end"]):
            value = load_reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": v, "limit": rec.cell.limits[k]} for k, v in rec.checks.items()}
    correct = rec.failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    cuda = torch.device(rec.cell.device).type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu", "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": rec.memory_peak_bytes}
    line = {"correct": correct, "attempted": rec.attempted, "failed": rec.failed, "metrics": metrics, "device": device}
    if trace and rec.idle is not None:
        device["busy_s"] = rec.idle.busy_s
        device["window_s"] = rec.idle.window_s
    if trace and rec.summary is not None:
        line["breakdown"] = {"device_ops": [list(x) for x in rec.summary.device_ops],
                             "idle_gaps": [list(x) for x in rec.summary.idle_gaps]}
    line["checks"] = checks
    return line


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    bench = load_benchmark(ROOT)
    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    print(f"portbench: card {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    rec, line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", bench)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; the port's benchmark runs without JAX", file=sys.stderr)
        return 3
    print("portbench: " + json.dumps({"info": rec.info, "counters": rec.counters,
                                      "memory_peak_bytes": rec.memory_peak_bytes}), flush=True)
    print(json.dumps(line), flush=True)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
