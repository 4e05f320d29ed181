"""The reduction of a ``torch.profiler`` trace to the numbers the per-layer
metrics read.

A traced run profiles a slice of its window that starts and ends on a
``torch.cuda.synchronize()`` and lies inside a span named ``SLICE``; the
benchmark wraps the calls into a layer it measures in spans of its own
(``portbench.<layer>``). The reduction reads the profiler's raw events
(``kineto_results``; no ``FunctionEvent`` list is built) and attributes each
device operation to the host by the profiler's correlation, never by the
kernel's name: the runtime call that launched it (same correlation id) gives
the thread and the moment of the launch, or else the op it is linked to
gives them. Then

- an operation launched inside a layer's span belongs to that layer;
- one launched inside an autograd node's ``evaluate_function`` whose
  sequence number is that of an op recorded inside the span (on the span's
  thread) belongs to the same layer's backward.

The spans' own device-side ranges (``gpu_user_annotation``, which bear the
span's name: ours, the optimizer's) are not operations and are left out.
"""

from __future__ import annotations

import bisect
import collections
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

SLICE = "portbench.slice"
EVALUATE = "autograd::engine::evaluate_function: "
SHORT_GAP_NS = 20_000
TOP = 10
RUNTIME_CALL = re.compile(r"^cu(da)?[A-Z]")


@dataclass
class TraceSummary:
    window_s: float  # the slice, host clock of the profiler
    busy_s: float  # the union of device activity inside it
    kernels: int  # kernel launches (copies and fills left out)
    device_s: float  # summed device time of every operation
    layer_device_s: Dict[str, float] = field(default_factory=dict)  # summed device time per measured layer
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def _is_device(ev) -> bool:
    return str(ev.device_type()).split(".")[-1] != "CPU"


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def _intervals_union(iv: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class _Enclosing:
    """Innermost-op queries on one thread's ops (intervals that nest)."""

    def __init__(self, ops):
        self.ops = sorted(ops, key=lambda o: (o[0], -o[1]))
        self.starts = [o[0] for o in self.ops]

    def innermost(self, t: int, pred=None):
        i = bisect.bisect_right(self.starts, t) - 1
        best = None
        # walk back over ops that start before t; nested ops start later, so the first that holds t and passes wins
        steps = 0
        while i >= 0 and steps < 4096:
            s, e, payload = self.ops[i]
            if e >= t and (pred is None or pred(payload)):
                best = payload
                break
            i -= 1
            steps += 1
        return best


def summarise(kineto_events, layers: Sequence[str] = ()) -> Optional[TraceSummary]:
    """The slice's summary, or None when the trace holds no slice or no device
    activity inside it. ``layers`` names the spans (``portbench.<name>``)
    whose forward and backward device time is summed per layer."""
    cpu, dev = [], []
    for ev in kineto_events:
        (dev if _is_device(ev) else cpu).append(ev)
    # a span's device-side range bears the span's name (ours, the optimizer's): not an operation
    spans_named = {ev.name() for ev in cpu if not RUNTIME_CALL.match(ev.name())}
    dev = [ev for ev in dev if ev.name() not in spans_named]
    slices = [ev for ev in cpu if ev.name() == SLICE]
    if not slices or not dev:
        return None
    sl = slices[0]
    t0, t1 = sl.start_ns(), sl.start_ns() + sl.duration_ns()
    main_tid = sl.start_thread_id()

    by_corr, launches = {}, {}
    per_thread = collections.defaultdict(list)
    for ev in cpu:
        s, e = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        rec = (ev.name(), s, e, ev.start_thread_id(), ev.sequence_nr(), ev.fwd_thread_id())
        per_thread[rec[3]].append((s, e, rec))
        if RUNTIME_CALL.match(rec[0]):  # a runtime call's id is CUPTI's correlation, shared by what it launched
            launches[ev.correlation_id()] = (s, rec[3])
        else:
            by_corr[ev.correlation_id()] = rec
    enclosing = {tid: _Enclosing(ops) for tid, ops in per_thread.items()}

    # per layer: its spans per thread, and the (thread, sequence number) of every op recorded inside them
    spans = {name: collections.defaultdict(list) for name in layers}
    for name, s, e, tid, _, _ in by_corr.values():
        if name.startswith("portbench.") and name[len("portbench."):] in spans:
            spans[name[len("portbench."):]][tid].append((s, e))
    span_starts = {}
    seqs = {name: set() for name in layers}
    for name, sp in spans.items():
        for tid, ivs in sp.items():
            ivs.sort()
            starts = span_starts[name, tid] = [a for a, _ in ivs]
            for s, e, rec in per_thread[tid]:
                i = bisect.bisect_right(starts, s) - 1
                if rec[4] is not None and rec[4] >= 0 and i >= 0 and ivs[i][1] >= s:
                    seqs[name].add((tid, rec[4]))

    def layer_at(t: int, tid: int) -> Optional[str]:
        for name, sp in spans.items():
            if tid in sp:
                i = bisect.bisect_right(span_starts[name, tid], t) - 1
                if i >= 0 and sp[tid][i][1] >= t:
                    return name
        node = enclosing[tid].innermost(t, lambda r: r[0].startswith(EVALUATE)) if tid in enclosing else None
        if node is not None:
            for name in layers:
                if (node[5], node[4]) in seqs[name]:
                    return name
        return None

    busy_iv, by_name = [], collections.Counter()
    layer_s = {name: 0.0 for name in layers}
    kernels, device_ns = 0, 0
    for ev in dev:
        s, e = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        if e <= t0 or s >= t1:
            continue
        s, e = max(s, t0), min(e, t1)
        busy_iv.append((s, e))
        device_ns += e - s
        name = ev.name()
        by_name[name] += (e - s) / 1e9
        if not _is_copy(name):
            kernels += 1
        if layers:
            at = launches.get(ev.correlation_id())
            if at is None:
                rec = by_corr.get(ev.linked_correlation_id())
                at = (rec[1], rec[3]) if rec is not None else None
            lay = layer_at(*at) if at is not None else None
            if lay is not None:
                layer_s[lay] += (e - s) / 1e9
    if not busy_iv:
        return None
    union = _intervals_union(busy_iv)
    busy_ns = sum(e - s for s, e in union)

    # idle gaps inside the slice, named by what the slice's thread was doing at their middle
    gaps, edges = collections.Counter(), [t0] + [x for iv in union for x in iv] + [t1]
    main = enclosing.get(main_tid)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        if b - a < SHORT_GAP_NS:
            gaps["gaps_under_20_us"] += (b - a) / 1e9
            continue
        op = main.innermost((a + b) // 2, lambda r: r[0] != SLICE) if main else None
        gaps[op[0] if op else "host:no_op"] += (b - a) / 1e9
    return TraceSummary(
        window_s=(t1 - t0) / 1e9, busy_s=busy_ns / 1e9, kernels=kernels, device_s=device_ns / 1e9,
        layer_device_s=layer_s,
        device_ops=[(n[:64], v) for n, v in by_name.most_common(TOP)],
        idle_gaps=[(n[:64], v) for n, v in gaps.most_common(TOP)],
    )


def device_summary(kineto_events, window_s: float) -> Optional[TraceSummary]:
    """busy_s, kernels and device time of a device-only trace over a window
    timed by the host (every event lies inside it)."""
    iv, kernels = [], 0
    for ev in kineto_events:
        if _is_device(ev) and ev.name() != SLICE:
            iv.append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
            kernels += not _is_copy(ev.name())
    if not iv:
        return None
    busy = sum(e - s for s, e in _intervals_union(iv)) / 1e9
    return TraceSummary(window_s=window_s, busy_s=busy, kernels=kernels,
                        device_s=sum(e - s for s, e in iv) / 1e9)
