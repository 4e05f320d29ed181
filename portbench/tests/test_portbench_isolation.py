"""Nothing the benchmark runs loads JAX or the JAX package, and the
references load nothing of the port. Each check runs in a fresh process and
compares top-level module names whole (``xrnerf_torch`` begins with
``xrnerf_tpu``'s name)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from portbench import run
from portbench.tests import tiny

PROBE = """
import importlib, json, sys
sys.path.insert(0, {root!r})
for name in {modules!r}:
    importlib.import_module(name)
{extra}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def top_level(modules, extra=""):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=run.ROOT, modules=modules, extra=extra)],
                         capture_output=True, text=True, env=env, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_every_cell_load_no_jax():
    bench = tiny.bench()  # the committed cells and those under portbench/later/
    mods = ["portbench", "portbench.run", "portbench.tools.readings"]
    for w in bench["workloads"]:
        _, _, traffic, cfg = run.cell_entries(bench, w["name"])
        mods += [f"portbench.families.{cfg['family']}", f"portbench.mixes.{traffic['kind']}",
                 f"portbench.reference.{cfg['family']}"]
    readers = "from portbench import run as r\n" + "".join(
        f"r.load_reader({m['name']!r})\n" for m in bench["per_layer"])
    names = top_level(mods + ["xrnerf_torch", "xrnerf_torch.core.trainer"], readers)
    assert "xrnerf_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "xrnerf_tpu"}
    assert run.forbidden_modules.__doc__


def test_the_references_load_nothing_of_the_port():
    names = top_level(["portbench.reference.nerf", "portbench.reference.ngp", "portbench.reference.lowp",
                       "portbench.lib.scene", "portbench.lib.flops", "portbench.lib.trace"])
    assert "torch" in names and "xrnerf_torch" not in names


def test_forbidden_names_are_compared_whole(monkeypatch):
    """A module counts by its whole top-level name: ``xrnerf_tpu_tools`` and
    ``jaxtyping`` are not JAX's, ``jax.numpy`` and ``xrnerf_tpu.ops`` are."""
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "xrnerf_tpu", raising=False)
    before = set(run.forbidden_modules())
    for name in ("xrnerf_tpu_tools", "jaxtyping_probe", "xrnerf_torch_probe"):
        monkeypatch.setitem(sys.modules, name, type(sys)(name))
    assert set(run.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "jax.numpy", type(sys)("jax.numpy"))
    monkeypatch.setitem(sys.modules, "xrnerf_tpu.ops", type(sys)("xrnerf_tpu.ops"))
    assert {"jax", "xrnerf_tpu"} <= set(run.forbidden_modules())
