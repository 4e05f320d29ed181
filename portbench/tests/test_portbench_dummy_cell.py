"""A cell, a traffic mix and a per-layer metric are added as new files and
new BENCHMARK.json entries alone: in a copy of the benchmark, a dummy cell
(vanilla NeRF serving a smaller view) with its own metric runs with no
existing file edited."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from portbench import run

SCRIPT = """
import json, sys
sys.path.insert(0, {copy!r})
sys.path.append({repo!r})
from portbench import run
from portbench.tests import tiny
assert run.ROOT == {copy!r}, run.ROOT
ov = tiny.overrides("nerf_blender.render.800")
ov["traffic"] = {{}}
rec, line = run.run_cell("nerf_blender.render.dummy", 5, 0.1, True, "cpu", overrides=ov, cache_root={cache!r})
print(json.dumps(line))
"""


def test_a_cell_added_as_files(tmp_path):
    copy = str(tmp_path / "checkout")
    os.makedirs(copy)
    before = {}
    for dirpath, _, files in os.walk(os.path.join(run.ROOT, "portbench")):
        for f in files:
            if f.endswith((".py", ".json")):
                p = os.path.join(dirpath, f)
                before[os.path.relpath(p, run.ROOT)] = open(p, "rb").read()
    shutil.copytree(os.path.join(run.ROOT, "portbench"), os.path.join(copy, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = run.load_benchmark(run.ROOT)
    bench["workloads"].append({"name": "nerf_blender.render.dummy", "config": "nerf_blender", "traffic": "render.dummy",
                               "chips": 1, "why": "a smaller view"})
    for m in bench["end_to_end"]:
        if m["name"].startswith("frame_ms") and m["name"].endswith(".nerf"):
            m["workloads"].append("nerf_blender.render.dummy")
    bench["per_layer"].append({"name": "frames.dummy", "unit": "frames", "better": "higher", "source": "host_clock",
                               "layer": "chunked renderer", "moves": "frame_ms.nerf", "workloads": ["nerf_blender.render.dummy"]})
    with open(os.path.join(copy, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    with open(os.path.join(copy, "portbench", "traffic", "render.dummy.json"), "w") as f:
        json.dump({"kind": "render", "size": 16, "camera_angle_x": 0.69, "poses": 3, "warmup_frames": 1,
                   "trace_after": 0, "trace_frames": 1, "check_pixels": 32}, f)
    with open(os.path.join(copy, "portbench", "limits", "nerf_blender.render.dummy.json"), "w") as f:
        json.dump({"limits": {"worst_frame_rmse": 0.02}}, f)
    with open(os.path.join(copy, "portbench", "metrics", "frames.dummy.py"), "w") as f:
        f.write("def read(run):\n    return float(run.counters['frames'])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(copy=copy, repo=run.ROOT, cache=str(tmp_path / "c"))],
                         capture_output=True, text=True, env=env, timeout=600, cwd=copy)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["metrics"]["frames.dummy"]["value"] >= 1
    for rel, data in before.items():  # nothing that was there changed
        assert open(os.path.join(copy, rel), "rb").read() == data, rel
