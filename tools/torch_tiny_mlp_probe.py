#!/usr/bin/env python3
"""The tiny-MLP forward kernels alone on one CUDA card, and variants of the
colour net's forward built from the same source with other constants.

    python3 tools/torch_tiny_mlp_probe.py                       # from the repo root
    python3 tools/torch_tiny_mlp_probe.py --names fused_mlp3_fwd --rows 129,262144 \\
        --variants "CTAS_PER_SM=2" "STAGES=3" "CTAS_PER_SM=2,STAGES=3"

Builds ``csrc/fused_mlp_fwd.cu`` (seconds, where ``chip_smoke.py`` builds
five kernels and drives every path) and runs ``chip_smoke.py``'s tiny-MLP
``kernel`` phase: the same checks against the plain versions (and the same
bits twice), the same L2-cold timing behind a spin kernel, the library
yardstick. Each ``--variants`` entry rewrites ``constexpr int NAME = ...;``
lines of a copy of ``csrc/`` (each name must appear exactly once), builds
it with the same ``nvcc`` flags, all builds started together, and runs the
same phase on it. The source's own constants run first and last, so each
variant sits between two readings of the kernel as committed. Prints JSON
lines, the card's name and power limit first, each variant's ptxas lines;
stops at the first check that fails. Needs a card; run it under
``timeout``, since a wrong mbarrier count hangs a kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402
from xrnerf_torch.ops import build  # noqa: E402
from xrnerf_torch.ops import fused_mlp as fm  # noqa: E402


def variant(text: str) -> dict:
    """"A=1,B=2" -> {"A": "1", "B": "2"}."""
    out = {}
    for item in filter(None, text.split(",")):
        name, _, value = item.partition("=")
        out[name.strip()] = value.strip()
    return out


def build_variant(tag: str, consts: dict) -> tuple:
    """``csrc/`` copied to ``_build/variants/<tag>/`` with the constants
    rewritten, ``fused_mlp_fwd.cu`` built there; (library path, ptxas lines)."""
    vdir = build.BUILD_DIR / "variants" / tag
    shutil.rmtree(vdir, ignore_errors=True)
    shutil.copytree(build.CSRC, vdir)
    src = vdir / "fused_mlp_fwd.cu"
    text = src.read_text()
    for name, value in consts.items():
        text, hits = re.subn(rf"constexpr int {re.escape(name)} = [^;]+;", f"constexpr int {name} = {value};", text)
        if hits != 1:
            raise SystemExit(f"variant {tag}: `constexpr int {name}` appears {hits} times in fused_mlp_fwd.cu")
    src.write_text(text)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    lib = vdir / "fused_mlp_fwd.so"
    proc = subprocess.run([nvcc, *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for variant {tag}:\n{proc.stdout}")
    return lib, [ln.strip() for ln in proc.stdout.splitlines() if "registers" in ln or "spill" in ln]


def rows(text):
    return tuple(int(s) for s in text.split(",") if s)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--names", default="fused_mlp2_fwd,fused_mlp3_fwd")
    ap.add_argument("--rows", type=rows, default=None, help="row counts (default: chip_smoke.py's)")
    ap.add_argument("--variants", nargs="*", default=[], help='e.g. "CTAS_PER_SM=2,STAGES=3"')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch sees no CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0],
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    names = [n for n in args.names.split(",") if n]
    counts = {n: args.rows or C.TINY_FWD_ROWS[n] for n in names}
    variants = [(re.sub(r"[^A-Za-z0-9]+", "_", v).strip("_"), variant(v)) for v in args.variants]

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1 + len(variants)) as ex:
        committed = ex.submit(build.load_library, "fused_mlp_fwd")
        built = [ex.submit(build_variant, tag, consts) for tag, consts in variants]
        committed.result()
        built = [b.result() for b in built]
    log = build.lib_path("fused_mlp_fwd").with_suffix(".log").read_text()
    C.emit({"phase": "build", "seconds": time.perf_counter() - t0,
            "ptxas": [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln],
            "variants": {tag: ptxas for (tag, _), (_, ptxas) in zip(variants, built)}})

    gen = torch.Generator(device=dev).manual_seed(C.SEED)
    runs = [("committed", fm._kernel_lib("fwd"))]
    runs += [(tag, fm.bind_library(ctypes.CDLL(str(lib)), "fwd")) for (tag, _), (lib, _) in zip(variants, built)]
    if variants:
        runs.append(runs[0])
    for tag, lib in runs:
        fm._LIBS["fwd"] = lib
        print(json.dumps({"variant": tag, "smem_bytes": lib.xr_fused_mlp3_fwd_smem_bytes()}), flush=True)
        C.tiny_mlp_phase(dev, gen, counts)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
