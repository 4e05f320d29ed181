"""Sizes at which a cell runs on the CPU in the benchmark's tests: the same
code paths, a few rays, the plain (f32) versions of the port's networks
unless a test asks for the fused path's plain versions; and the benchmark
with the cells that wait under ``portbench/later/`` (:func:`bench`)."""

from __future__ import annotations

import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def config(name: str) -> dict:
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def bench() -> dict:
    """BENCHMARK.json with the entries of each file under ``portbench/later/``
    added, as a later PR adds them."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        out = json.load(f)
    later = os.path.join(ROOT, "portbench", "later")
    for name in sorted(os.listdir(later)):
        with open(os.path.join(later, name)) as f:
            part = json.load(f)
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            out[key] = out[key] + part.get(key, [])
    return out


def overrides(workload: str, fused: bool = False) -> dict:
    if workload.startswith("nerf_blender"):
        model = dict(config("nerf_blender")["model"], n_samples=8, n_importance=8, fused=fused)
        if ".train." in workload:
            return {"cfg": {"model": model},
                    "traffic": {"N_rand": 64, "warmup_steps": 4, "trace_after": 1, "trace_steps": 2,
                                "reference_block": 32,
                                "scene": {"size": 32, "camera_angle_x": 0.69, "views": 4, "poses": "sphere",
                                          "pose_seed": 0, "radius": 4.0}}}
        return {"cfg": {"model": model, "eval_chunk": 256}, "traffic": RENDER}
    cfg = config("ngp_blender")
    model = dict(cfg["model"], grid_res=32, grid_update_samples=4096, n_candidates=64, n_keep=16,
                 sample_budget=2048, log2_table_size=14, fused=fused)
    if not fused:
        model["dtype"] = "float32"
    return {"cfg": {"model": model, "eval_chunk": 256, "grid_refreshes": 4,
                    "weights": dict(cfg["weights"], calibration_points=4096)},
            "traffic": RENDER}


RENDER = {"size": 24, "poses": 4, "warmup_frames": 1, "trace_after": 1, "trace_frames": 1, "check_pixels": 64}
