#!/usr/bin/env python3
"""The two fused vanilla-NeRF MLP kernels alone on one CUDA card.

    python3 tools/torch_nerf_mlp_probe.py                 # from the repo root
    python3 tools/torch_nerf_mlp_probe.py --fwd-rows 129,1000 --bwd-rows 129

Builds ``fused_nerf_mlp_fwd`` and ``fused_nerf_mlp_bwd`` only (seconds, where
``chip_smoke.py`` builds five kernels and drives every path) and runs
``chip_smoke.py``'s own ``kernel`` and ``bwd_kernel`` phases at the given row
counts: the same checks against the plain versions, the same timing beside
the library yardstick, the backward by pass. For work on these two kernels.
Prints JSON lines, the card's name and power limit first; stops at the first
check that fails. Needs a card; run it under ``timeout``, since a wrong
mbarrier count hangs a kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402
from xrnerf_torch.ops import build  # noqa: E402
from xrnerf_torch.ops.fused_nerf_mlp import pack_params  # noqa: E402
from xrnerf_torch.utils.weights import state_dict_from_jax  # noqa: E402


def rows(text):
    return tuple(int(s) for s in text.split(",") if s)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fwd-rows", type=rows, default=C.FWD_ROWS)
    ap.add_argument("--bwd-rows", type=rows, default=C.BWD_ROWS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch sees no CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0],
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    build.load_libraries(["fused_nerf_mlp_fwd", "fused_nerf_mlp_bwd"])
    C.emit({"phase": "build", "seconds": time.perf_counter() - t0})

    rng = np.random.RandomState(C.SEED)
    sd = {k: torch.from_numpy(v).to(dev) for k, v in state_dict_from_jax(C.seeded_mlp_tree(rng)).items()}
    packed = pack_params(sd, 63, 27)
    gen = torch.Generator(device=dev).manual_seed(C.SEED)
    C.fwd_kernel_phase(dev, packed, gen, args.fwd_rows)
    C.bwd_kernel_phase(dev, packed, gen, args.bwd_rows)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
