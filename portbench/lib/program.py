"""The reduction of the program's own spans in a traced slice.

The port records spans of its own while a profiler runs
(``xrnerf_torch.<stage>``, ``xrnerf_torch/utils/spans.py``). ``summarise``
reads the same raw events as ``lib/trace.py:summarise`` and sums each span
under its name: its count and host time; the device time of the operations
whose launch lies in it as the innermost program span of the launching
thread, or in an autograd node whose forward op was recorded there (the
rule of ``trace.py``'s layers, keyed by the innermost program span); and the
idle gaps of ``SHORT_GAP_NS`` or more whose middle lies in it, as the
innermost program span of the slice's thread.

No run of the benchmark calls it: a run's slices keep only their
``TraceSummary``, so a per-layer metric that reads the spans needs
``trace.py`` or ``mixes/common.py:Slice.summary`` to carry this reduction
(PERF.md, §7). ``tools/spans.py`` runs a cell with it.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, Optional

from .trace import EVALUATE, RUNTIME_CALL, SHORT_GAP_NS, SLICE, _Enclosing, _intervals_union, _is_device

PROGRAM = "xrnerf_torch."


@dataclass
class ProgramSpans:
    device_s: float  # summed device time of every operation in the slice
    idle_s: float  # gaps of SHORT_GAP_NS or more in the slice
    # per span: count, host_s, device_s (forward and backward), idle_s
    spans: Dict[str, Dict[str, float]] = field(default_factory=dict)


def summarise(kineto_events) -> Optional[ProgramSpans]:
    """The program's spans in the slice, or None when the trace holds no
    slice or no device activity inside it."""
    cpu, dev = [], []
    for ev in kineto_events:
        (dev if _is_device(ev) else cpu).append(ev)
    spans_named = {ev.name() for ev in cpu if not RUNTIME_CALL.match(ev.name())}
    dev = [ev for ev in dev if ev.name() not in spans_named]
    slices = [ev for ev in cpu if ev.name() == SLICE]
    if not slices or not dev:
        return None
    t0, t1 = slices[0].start_ns(), slices[0].start_ns() + slices[0].duration_ns()
    main_tid = slices[0].start_thread_id()

    # every host op (two can share a correlation id, so spans are read from all of them), launches by correlation
    by_corr, launches, per_thread = {}, {}, collections.defaultdict(list)
    spans, prog_spans = {}, collections.defaultdict(list)
    for ev in cpu:
        name, s = ev.name(), ev.start_ns()
        e, tid = s + ev.duration_ns(), ev.start_thread_id()
        if RUNTIME_CALL.match(name):
            launches[ev.correlation_id()] = (s, tid)
            continue
        rec = (name, s, e, tid, ev.sequence_nr(), ev.fwd_thread_id())
        by_corr[ev.correlation_id()] = rec
        per_thread[tid].append((s, e, rec))
        if name.startswith(PROGRAM) and t0 <= s < t1:
            p = spans.setdefault(name, {"count": 0, "host_s": 0.0, "device_s": 0.0, "idle_s": 0.0})
            p["count"] += 1
            p["host_s"] += (min(e, t1) - s) / 1e9
            prog_spans[tid].append((s, e, name))
    prog_at = {tid: _Enclosing(sp) for tid, sp in prog_spans.items()}
    enclosing = {tid: _Enclosing(ops) for tid, ops in per_thread.items()}
    # the innermost program span of every op with a sequence number: its backward node's span
    prog_seq = {}
    for tid, at in prog_at.items():
        for s, _, rec in per_thread[tid]:
            if rec[4] is not None and rec[4] >= 0:
                name = at.innermost(s)
                if name is not None:
                    prog_seq[tid, rec[4]] = name

    def span_at(t: int, tid: int) -> Optional[str]:
        name = prog_at[tid].innermost(t) if tid in prog_at else None
        if name is None and tid in enclosing:
            node = enclosing[tid].innermost(t, lambda r: r[0].startswith(EVALUATE))
            name = prog_seq.get((node[5], node[4])) if node is not None else None
        return name

    busy_iv, device_ns = [], 0
    for ev in dev:
        s, e = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        if e <= t0 or s >= t1:
            continue
        s, e = max(s, t0), min(e, t1)
        busy_iv.append((s, e))
        device_ns += e - s
        at = launches.get(ev.correlation_id())
        if at is None:
            rec = by_corr.get(ev.linked_correlation_id())
            at = (rec[1], rec[3]) if rec is not None else None
        name = span_at(*at) if at is not None else None
        if name is not None:
            spans[name]["device_s"] += (e - s) / 1e9
    if not busy_iv:
        return None

    idle_ns = 0
    edges = [t0] + [x for iv in _intervals_union(busy_iv) for x in iv] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b - a < SHORT_GAP_NS:
            continue
        idle_ns += b - a
        name = prog_at[main_tid].innermost((a + b) // 2) if main_tid in prog_at else None
        if name is not None:
            spans[name]["idle_s"] += (b - a) / 1e9
    return ProgramSpans(device_s=device_ns / 1e9, idle_s=idle_ns / 1e9, spans=spans)
