#!/usr/bin/env python3
"""The scatter's mode choices on one real Instant-NGP training step, on one
CUDA card.

    python3 tools/torch_ngp_kernel_probe.py [--steps 8]

Trains a full-width Instant-NGP trainer (``chip_smoke.py``'s config and
scene) ``--steps`` steps, captures the 16 levels' ids and update rows that
one more step hands ``scatter_add_rows_levels`` (``chip_smoke.py``'s
``capture_vertex_step``), and times the kernel on them (march order) and on
random points (``chip_smoke.py``'s ``vertex_streams``):

- ``modes_ms``: the 16 levels in one launch under the host's rule
  (``level_modes``: the coarsest level's table in shared memory, the other
  levels' runs summed in the warp), with no shared table, and with every
  table of at most 96 KB in shared memory;
- ``per_level_ms``: each level alone in each mode it can take.

Prints one JSON object per line, the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8, help="training steps before the capture")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    if not torch.cuda.is_available():
        print("torch_ngp_kernel_probe: torch sees no CUDA card", file=sys.stderr)
        return 2
    from xrnerf_torch import build_network, load_config
    from xrnerf_torch.core.trainer import Trainer
    from xrnerf_torch.ops import build
    from xrnerf_torch.ops import scatter_rows as sr

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    build.load_libraries(["fused_mlp_fwd", "fused_mlp_bwd", "scatter_rows"])
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    cfg = load_config(os.path.join(ROOT, "configs", "instant_ngp", "ngp_blender.py"), dataname="lego")
    model_cfg = dict(cfg["model"], fused=True)

    work_dir = tempfile.mkdtemp(prefix="ngp_kernel_probe_")
    try:
        tr = Trainer(build_network(model_cfg, device="cuda"), cs.NGPSphereScene(cs.N_RAND), optimizer=cfg["optimizer"],
                     work_dir=work_dir, max_iters=args.steps, log_interval=args.steps, seed=cs.SEED,
                     ema_decay=cfg["ema_decay"], device="cuda")
        tr.ckpt_interval = 0
        tr.run()
        batch = tr._put_batch(tr.dataset.train_batch(10_000))
        idx, vals, rows, T = cs.capture_vertex_step(tr, batch, 10_001)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    del tr, batch
    L, M, W = vals.shape
    shared_max = sr._kernel_lib().xr_scatter_add_rows_max_shared_bytes()
    choices = {"rule": sr.level_modes(rows, W), "no_shared_table": [sr.AGGREGATE] * L,
               "shared_96k": [sr.SHARED if r * W * 4 <= 96 * 1024 else sr.AGGREGATE for r in rows]}

    def run(i, v, r, modes):
        return sr._launch(sr.scatter_add_rows_levels, i, v, r, T, False, modes)

    for label, (i, v) in cs.vertex_streams(dev, gen, model_cfg, idx, vals).items():
        want = sr.scatter_add_rows_levels_plain(i, v, rows, T)
        modes_ms = {}
        for name, modes in choices.items():
            cs.scatter_check(f"{label} {name}", run(i, v, rows, modes), want)
            modes_ms[name] = cs.time_ms(lambda m=modes: run(i, v, rows, m), inner=10, head_start_ms=4.0)
        per_level = [{name: cs.time_ms(lambda m=m, lvl=lvl: run(i[lvl:lvl + 1], v[lvl:lvl + 1], [rows[lvl]], [m]),
                                       inner=10, head_start_ms=4.0)
                      for name, m in (("shared", sr.SHARED), ("aggregate", sr.AGGREGATE))
                      if m != sr.SHARED or rows[lvl] * W * 4 <= shared_max}
                     for lvl in range(L)]
        cs.emit({"phase": "step_scatter", "stream": label, "levels": L, "rows": M, "width": W, "rows_per_level": rows,
                 "modes": choices, "modes_ms": modes_ms, "per_level_ms": per_level})
    cs.emit({"ok": True})
    return 0


if __name__ == "__main__":
    sys.exit(main())
