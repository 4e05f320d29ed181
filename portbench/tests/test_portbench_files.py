"""Each cell's files load by name, and BENCHMARK.json keeps the contract's
format: as committed, with the entries that wait under ``portbench/later/``
added, and as the PR that adds the waiting cell leaves it: the cell's
entries moved into BENCHMARK.json, with ``later/`` left as it is and with
``later/`` removed."""

from __future__ import annotations

import importlib
import json
import os
import re
import shutil

import pytest

from portbench import run
from portbench.tests import tiny

ROOT = run.ROOT
ABSENT = os.path.join(ROOT, "portbench", "later_removed")  # no such directory: later/ once a PR removes it


def waiting_moved(committed: dict) -> dict:
    """``committed`` with the entries under ``later/`` moved in, as the PR
    that adds a waiting cell moves them: a new cell takes the bounds the
    benchmark has, so ``frame_ms.ngp`` gets ``frame_ms_p95.nerf``'s 0.03,
    not the 0.07 parked with it."""
    out = tiny.bench(committed)
    for m in out["end_to_end"]:
        if m["name"] == "frame_ms.ngp" and m not in committed["end_to_end"]:
            m["bound"] = 0.03
    return out


COMMITTED = run.load_benchmark(ROOT)
MOVED = waiting_moved(COMMITTED)
BENCHES = {"committed": COMMITTED, "with_later": tiny.bench(), "moved": tiny.bench(MOVED),
           "moved_later_removed": tiny.bench(MOVED, later=ABSENT)}
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


def test_a_waiting_cell_moves_by_additions_alone(tmp_path):
    """Moving a waiting cell's entries into BENCHMARK.json edits no file of
    the benchmark: ``later/``'s entries join only where BENCHMARK.json has
    none of the same name, so the benchmark reads the same, each entry once,
    whether ``later/`` stays or goes."""
    assert not os.path.exists(ABSENT)
    present = str(tmp_path / "later")
    if os.path.isdir(tiny.LATER):
        shutil.copytree(tiny.LATER, present)
    assert tiny.bench(MOVED, later=present) == tiny.bench(MOVED, later=ABSENT) == MOVED
    assert tiny.bench(COMMITTED, later=ABSENT) == COMMITTED
    for group in tiny.GROUPS:
        assert [e["name"] for e in COMMITTED[group]] == [e["name"] for e in MOVED[group]][:len(COMMITTED[group])]
    assert {w["name"] for w in BENCHES["with_later"]["workloads"]} <= {w["name"] for w in MOVED["workloads"]}
    # a cell's frame time, once committed, has a bound no looser than the benchmark's p95
    assert all(m["bound"] <= 0.03 for m in COMMITTED["end_to_end"] if m["name"].startswith("frame_ms."))
