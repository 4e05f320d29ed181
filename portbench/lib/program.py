"""The reduction of the program's own spans in a traced slice.

The port records spans of its own while a profiler runs
(``xrnerf_torch.<stage>``, ``xrnerf_torch/utils/spans.py``). ``summarise``
reads the host side that ``lib/trace.py:host`` parses (the same for both
reductions, and the one rule, ``Host.program_span_at``, for which span holds
a moment) and sums each span
under its name: its count and host time; the device time of the operations
whose launch lies in it as the innermost program span of the launching
thread, or in an autograd node whose forward op was recorded there (the
rule of ``trace.py``'s layers, keyed by the innermost program span); the
idle gaps of ``SHORT_GAP_NS`` or more whose middle lies in it, as the
innermost program span of the slice's thread (``idle_s``: where the host
was while the card waited); and those that follow an operation launched in
it (``idle_after_s``: after whose work the card waited, read from the
card's own timeline).

A traced run keeps it on its host-op slice's summary
(``TraceSummary.program``, ``mixes/common.py:Slice.summary``), where the
per-layer metrics' readers find it through :func:`span_ms`.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, Optional

from .trace import EVALUATE, PROGRAM, SHORT_GAP_NS, Host, host


@dataclass
class ProgramSpans:
    device_s: float  # summed device time of every operation in the slice
    idle_s: float  # gaps of SHORT_GAP_NS or more in the slice
    # per span: count, host_s, device_s (forward and backward), idle_s, idle_after_s
    spans: Dict[str, Dict[str, float]] = field(default_factory=dict)


def summarise(kineto_events) -> Optional[ProgramSpans]:
    """The program's spans in the slice, or None when the trace holds no
    slice or no device activity inside it."""
    h = host(kineto_events)
    return summarise_host(h) if h is not None else None


def summarise_host(h: Host) -> Optional[ProgramSpans]:
    """:func:`summarise` of a trace whose host side is parsed."""
    spans = {}
    for at in h.program.values():
        for s, e, name in at.ops:
            p = spans.setdefault(name, {"count": 0, "host_s": 0.0, "device_s": 0.0, "idle_s": 0.0, "idle_after_s": 0.0})
            p["count"] += 1
            p["host_s"] += (min(e, h.t1) - s) / 1e9
    # the innermost program span of every op with a sequence number: its backward node's span
    prog_seq = {}
    for tid in h.program:
        for s, _, rec in h.per_thread[tid]:
            if rec[4] is not None and rec[4] >= 0:
                name = h.program_span_at(s, tid)
                if name is not None:
                    prog_seq[tid, rec[4]] = name

    def span_at(t: int, tid: int) -> Optional[str]:
        name = h.program_span_at(t, tid)
        if name is None and tid in h.enclosing:
            node = h.enclosing[tid].innermost(t, lambda r: r[0].startswith(EVALUATE))
            name = prog_seq.get((node[5], node[4])) if node is not None else None
        return name

    busy_iv, device_ns, ended = [], 0, []
    for ev, s, e in h.in_slice():
        busy_iv.append((s, e))
        device_ns += e - s
        at = h.launched_at(ev)
        name = span_at(*at) if at is not None else None
        ended.append((e, name))
        if name is not None:
            spans[name]["device_s"] += (e - s) / 1e9
    if not busy_iv:
        return None

    ended.sort(key=lambda x: x[0])
    ends = [e for e, _ in ended]
    idle_ns = 0
    for a, b in h.gaps(busy_iv):
        if b - a < SHORT_GAP_NS:
            continue
        idle_ns += b - a
        name = h.program_span_at((a + b) // 2)
        if name is not None:
            spans[name]["idle_s"] += (b - a) / 1e9
        i = bisect.bisect_right(ends, a) - 1  # the operation whose end opens the gap
        if i >= 0 and ended[i][1] is not None:
            spans[ended[i][1]]["idle_after_s"] += (b - a) / 1e9
    return ProgramSpans(device_s=device_ns / 1e9, idle_s=idle_ns / 1e9, spans=spans)


def units(run) -> int:
    """The traced slice's steps or frames, by the traffic's kind."""
    return run.counters["slice_steps" if run.cell.traffic["kind"] == "train" else "slice_frames"]


def span_ms(run, name: str, key: str) -> Optional[float]:
    """``key`` (``host_s``, ``device_s``, ``idle_s`` or ``idle_after_s``) of the program span
    ``name`` in the run's host-op slice, in ms per traced step or frame;
    None where the run recorded no such span."""
    p = run.summary.program if run.summary is not None else None
    if p is None or name not in p.spans:
        return None
    return 1e3 * p.spans[name][key] / units(run)

