"""What the traffic mixes' code shares: the run's record, the spans a traced run puts
around the layers it measures, the profiled slice, and the gaps that the
correctness check compares."""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from ..lib import program as lprogram
from ..lib import trace as ltrace


@dataclass
class Cell:
    """One run's inputs."""

    name: str
    cfg: Dict
    traffic: Dict
    family: Any  # the family module
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: str
    cache_root: str
    t_start: float  # perf_counter at the process's start


@dataclass
class RunRecord:
    """What a run measured; the metric readers read it."""

    cell: Cell
    attempted: int = 0
    failed: int = 0
    end_to_end: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    summary: Optional[ltrace.TraceSummary] = None  # the traced slice with host ops, and the program's spans in it
    idle: Optional[ltrace.TraceSummary] = None  # the device-only slice after it
    checks: Dict[str, float] = field(default_factory=dict)
    memory_peak_bytes: int = 0
    info: Dict[str, Any] = field(default_factory=dict)


def sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def wrap_layers(modules: Dict[str, List[torch.nn.Module]]) -> None:
    """Put each module's forward in a span ``portbench.<layer>`` (traced runs
    only): the trace reduction gives the layer every device operation
    launched inside it and inside the autograd nodes of its ops."""
    for layer, mods in modules.items():
        for mod in mods:
            orig = mod.forward

            def forward(*args, _orig=orig, _name=f"portbench.{layer}", **kw):
                with torch.profiler.record_function(_name):
                    return _orig(*args, **kw)

            mod.forward = forward


class Slice:
    """A traced slice of a window: starts and ends on a synchronize, inside
    the span ``portbench.slice``. With ``device_only`` the profiler records
    the card's activity alone (no host ops, so no host overhead), and the
    slice is timed by the host's clock between the two synchronizes: the
    idle share is read from such a slice."""

    def __init__(self, device: str, device_only: bool = False):
        self.device, self.device_only = device, device_only
        self.prof = self.span = self.events = None
        self.t0 = self.t1 = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.device(self.device).type == "cuda"
        acts = ([] if self.device_only else [ProfilerActivity.CPU]) + ([ProfilerActivity.CUDA] if cuda else [])
        self.prof = profile(activities=acts or [ProfilerActivity.CPU])
        self.prof.start()
        sync(self.device)
        self.t0 = now()
        self.span = torch.profiler.record_function(ltrace.SLICE)
        self.span.__enter__()

    def stop(self) -> None:
        sync(self.device)
        self.t1 = now()
        self.span.__exit__(None, None, None)
        self.prof.stop()
        self.events = self.prof.profiler.kineto_results.events()

    def summary(self, layers) -> Optional[ltrace.TraceSummary]:
        if self.events is None:
            return None
        if self.device_only:
            return ltrace.device_summary(self.events, self.t1 - self.t0)
        h = ltrace.host(self.events)
        summary = ltrace.summarise_host(h, layers) if h is not None else None
        if summary is not None:
            summary.program = lprogram.summarise_host(h)
        return summary


def traced_slices(device: str, start: int, length: int):
    """The two slices of a traced run, back to back from unit ``start`` (a
    step or a frame), ``length`` units each: host ops and device activity
    (attribution, launches, breakdown), then the device's activity alone
    (the idle share and the rate the peak's share is read from)."""
    return [(start, start + length, Slice(device)), (start + length, start + 2 * length, Slice(device, True))]


def leaf_gap(got: Dict[str, float], want: Dict[str, float], skip=()) -> float:
    """The worst leaf's gap between two norms: |got - want| over the larger
    of want's norm and the median leaf's."""
    keep = [k for k in want if k not in skip]
    norms = sorted(want[k] for k in keep)
    median = norms[len(norms) // 2]
    return max(abs(got.get(k, math.inf) - want[k]) / max(want[k], median) for k in keep)


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def now() -> float:
    return time.perf_counter()

