"""Each cell's files load by name, and BENCHMARK.json keeps the contract's
format: as committed, and with the entries that wait under
``portbench/later/`` added."""

from __future__ import annotations

import importlib
import json
import os
import re

import pytest

from portbench import run
from portbench.tests import tiny

ROOT = run.ROOT
BENCHES = {"committed": run.load_benchmark(ROOT), "with_later": tiny.bench()}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [(k, w["name"]) for k, b in BENCHES.items() for w in b["workloads"]]
each_bench = pytest.mark.parametrize("bench", list(BENCHES.values()), ids=list(BENCHES))


@each_bench
def test_top_level_keys_and_paths(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(json.dumps(bench)) < 64 * 1024


@each_bench
def test_names_units_and_texts(bench):
    metric_names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer", "source") if group in ("configs", "workloads", "per_layer") else ():
                if key in e and not (group == "per_layer" and key == "source"):
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key], (e["name"], key)
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
                metric_names.append(e["name"])
    assert len(metric_names) == len(set(metric_names))
    for c in bench["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])


@each_bench
def test_end_to_end_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for cell in [w["name"] for w in bench["workloads"]]:
        mine = run.reported(bench["end_to_end"], cell, bench["end_to_end"])
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert run.reported(bench["per_layer"], cell, bench["end_to_end"])


@each_bench
def test_per_layer_metrics_move_a_metric_their_cells_report(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [w["name"] for w in bench["workloads"]])
        assert callable(run.load_reader(m["name"]))  # metrics/<name>.py, or that of a shorter dotted name


@pytest.mark.parametrize("which,cell", CELLS)
def test_cell_files_load_by_name(which, cell):
    bench = BENCHES[which]
    w, conf, traffic, cfg = run.cell_entries(bench, cell)
    assert w["chips"] == 1 and conf["file"].startswith("portbench/configs/")
    assert cfg["name"] == conf["name"] and cfg["reduced"] == conf["reduced"]
    importlib.import_module(f"portbench.families.{cfg['family']}")
    importlib.import_module(f"portbench.mixes.{traffic['kind']}")
    importlib.import_module(f"portbench.reference.{cfg['family']}")
    cellobj = run.make_cell(cell, 1, 1.0, False, "cpu", bench)
    assert cellobj.limits
    for m in run.reported(bench["per_layer"], cell, bench["end_to_end"]):
        assert callable(run.load_reader(m["name"]))


@each_bench
def test_every_config_is_used_and_files_are_distinct(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    assert len({c["file"] for c in bench["configs"]}) == len(bench["configs"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
