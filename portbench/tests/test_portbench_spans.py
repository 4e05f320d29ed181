"""The reduction of the program's spans (``lib/program.py``): on a
synthetic kineto-like trace, forward attribution, backward attribution by
sequence number, the innermost span winning, idle gaps put down to the span
the host was in; the spans' sums never above the slice's device time; every
field of ``lib/trace.py``'s summary but the gaps' names the same with and
without the spans; kineto's own events that bear an op's correlation id
take no span and no launch from the layers. The per-layer metrics that read
the spans, on a record with them and on one without. Then whole CPU runs of
both cells through ``tools/spans.py``, traced, with a device operation made
up for every leaf op of the profile (the CPU has no device activity): every
span is read with its count, the MLP's span reads what the benchmark's own
span around ``NerfMLP.forward`` reads, and each metric of the program's
spans is in the run's line."""

from __future__ import annotations

import math
from types import SimpleNamespace

import pytest

from portbench import run
from portbench.lib import program, trace
from portbench.mixes import common
from portbench.tests import tiny
from portbench.tools import spans as tool

US = 1000
MAIN, BWD = 1, 2


class Ev:
    """The methods of a kineto event that ``lib/trace.py`` reads."""

    _corr = 0

    def __init__(self, name, start_us, dur_us, tid=MAIN, seq=-1, fwd_tid=0, device=False, linked=0):
        Ev._corr += 1
        self._name, self._s, self._d = name, int(start_us * US), int(dur_us * US)
        self._tid, self._seq, self._fwd, self._dev = tid, seq, fwd_tid, device
        self._id, self._linked = Ev._corr, linked

    def name(self):
        return self._name

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def start_thread_id(self):
        return self._tid

    def sequence_nr(self):
        return self._seq

    def fwd_thread_id(self):
        return self._fwd

    def correlation_id(self):
        return self._id

    def linked_correlation_id(self):
        return self._linked


def launch(t_us, tid, start_us, dur_us, name="kernel"):
    """A runtime call at ``t_us`` on ``tid`` and the device operation it
    launched (same correlation id)."""
    call = Ev("cudaLaunchKernel", t_us, 1, tid)
    op = Ev(name, start_us, dur_us, device=True)
    op._id = call._id
    return [call, op]


def program_trace(shared_ids=True):
    """A slice of 1,000 us: a frame's spans on the main thread, an op with a
    sequence number inside the MLP's span and its backward node on another
    thread, the benchmark's own span around the MLP, and (``shared_ids``)
    two events that share the MLP spans' correlation ids, as kineto's buffer
    events do; device work with an idle gap while the host samples, and one
    with the host in no op."""
    evs = [Ev(trace.SLICE, 0, 1000),
           Ev("xrnerf_torch.render.image", 10, 900),
           Ev("xrnerf_torch.nerf.sample", 100, 100),
           Ev("xrnerf_torch.nerf.mlp", 300, 100),
           Ev("portbench.nerf_mlp", 305, 90),
           Ev("aten::mm", 310, 20, seq=7),
           Ev("autograd::engine::evaluate_function: MmBackward0", 600, 50, tid=BWD, seq=7, fwd_tid=MAIN),
           Ev("xrnerf_torch.render.image", 20, 880, device=True)]  # the span's device-side range: not an operation
    for span in evs[3:5] if shared_ids else ():  # CPU events of other kinds that share the spans' correlation ids
        evs.append(buffer_event(span))
    evs += launch(20, MAIN, 30, 70)  # render.image alone
    evs += launch(150, MAIN, 160, 20)  # sample, inside render.image: the innermost wins
    evs += launch(320, MAIN, 330, 100)  # the MLP's forward
    evs += launch(620, BWD, 630, 60)  # its backward, by sequence number
    evs += launch(920, MAIN, 930, 50)  # outside every program span
    return evs


def buffer_event(op, name="Command Buffer Full"):
    """One of kineto's own host events, as the card's trace has them: inside
    ``op``, on its thread, bearing its correlation id."""
    ev = Ev(name, op._s / US + 1, 1, tid=op._tid)
    ev._id = op._id
    return ev


def without_program(evs):
    return [e for e in evs if not e.name().startswith(program.PROGRAM)]


def test_forward_backward_innermost_and_idle_attribution():
    got = program.summarise(program_trace())
    p = got.spans
    assert {k: v["count"] for k, v in p.items()} == {
        "xrnerf_torch.render.image": 1, "xrnerf_torch.nerf.sample": 1, "xrnerf_torch.nerf.mlp": 1}
    assert p["xrnerf_torch.render.image"]["host_s"] == pytest.approx(900e-6)
    assert p["xrnerf_torch.render.image"]["device_s"] == pytest.approx(70e-6)
    assert p["xrnerf_torch.nerf.sample"]["device_s"] == pytest.approx(20e-6)
    assert p["xrnerf_torch.nerf.mlp"]["device_s"] == pytest.approx(160e-6)  # forward 100 + backward 60
    # the gaps and the innermost span at their middle: 0-30 and 180-330, 430-630, 690-930 render.image,
    # 100-160 sample, 980-1000 none
    assert p["xrnerf_torch.nerf.sample"]["idle_s"] == pytest.approx(60e-6)
    assert p["xrnerf_torch.render.image"]["idle_s"] == pytest.approx((30 + 150 + 200 + 240) * 1e-6)
    assert p["xrnerf_torch.nerf.mlp"]["idle_s"] == 0.0
    assert got.idle_s == pytest.approx(700e-6)
    # the same gaps by the span that launched the operation before them: 100-160 render.image, 180-330 sample,
    # 430-630 and 690-930 the MLP (forward, backward); 0-30 follows nothing, 980-1000 an op launched in no span
    assert {k: v["idle_after_s"] for k, v in p.items()} == pytest.approx({
        "xrnerf_torch.render.image": 60e-6, "xrnerf_torch.nerf.sample": 150e-6, "xrnerf_torch.nerf.mlp": 440e-6})


def test_program_device_time_within_the_slice():
    got = program.summarise(program_trace())
    assert sum(v["device_s"] for v in got.spans.values()) <= got.device_s + 1e-12
    assert got.device_s == pytest.approx(300e-6)  # the span's device-side range is no operation
    assert got.device_s == pytest.approx(trace.summarise(program_trace()).device_s)


def test_mlp_span_reads_the_benchmarks_layer():
    evs = program_trace(shared_ids=False)
    assert program.summarise(evs).spans["xrnerf_torch.nerf.mlp"]["device_s"] == pytest.approx(
        trace.summarise(evs, ("nerf_mlp",)).layer_device_s["nerf_mlp"])


def test_trace_fields_unchanged_by_program_spans():
    evs = program_trace()
    got, want = trace.summarise(evs, ("nerf_mlp",)), trace.summarise(without_program(evs), ("nerf_mlp",))
    for key in ("window_s", "busy_s", "kernels", "device_s", "layer_device_s", "device_ops"):
        assert getattr(got, key) == getattr(want, key), key
    assert program.summarise(without_program(evs)).spans == {}


def test_a_gap_deep_in_a_long_span_is_put_down_to_it():
    """Past 4,096 ops the breakdown's walk over every op gives up; the
    program's spans alone are walked, so the gap is put down to the span it
    lies in, in the program's reduction and in the breakdown."""
    evs = [Ev(trace.SLICE, 0, 1000), Ev("xrnerf_torch.render.image", 10, 980)]
    evs += [Ev("aten::view", 20 + i * 0.05, 0.01) for i in range(5000)]  # 20-270 us
    evs += launch(15, MAIN, 16, 4) + launch(280, MAIN, 600, 100)  # gaps 20-600 and 700-1000 us, both in the span
    assert program.summarise(evs).spans["xrnerf_torch.render.image"]["idle_s"] == pytest.approx(880e-6)
    gaps = dict(trace.summarise(evs).idle_gaps)
    assert gaps["xrnerf_torch.render.image"] == pytest.approx(880e-6) and "host:no_op" not in gaps


@pytest.mark.parametrize("first", [False, True], ids=["after_the_ops", "before_the_ops"])
@pytest.mark.parametrize("name", ["Activity Buffer Request", "Command Buffer Full", "Buffer Flush"])
def test_kinetos_own_events_take_nothing_from_a_layer(name, first):
    """A buffer event that bears the correlation id of the benchmark's span,
    of the program's span, or of an op whose kernel is found by its linked
    id alone, wherever it lies in the event list, drops neither the span
    from ``layer_device_s`` nor the kernel from the span (on the card each
    follows its op in the list: 20 in a traced training slice)."""
    evs = program_trace(shared_ids=False)
    op = Ev("aten::addmm", 340, 10)  # inside portbench.nerf_mlp; its kernel has no runtime call
    kernel = Ev("kernel", 440, 30, device=True, linked=op._id)
    kernel._id = -1
    evs += [op, kernel]
    owners = (evs[3], evs[4], op)
    bufs = [buffer_event(x, name) for x in owners]
    evs = bufs + evs if first else evs + bufs
    by_corr = trace.host(evs).by_corr
    assert [by_corr[x._id][0] for x in owners] == [x.name() for x in owners]
    got = trace.summarise(evs, ("nerf_mlp",)).layer_device_s["nerf_mlp"]
    assert got == pytest.approx((100 + 60 + 30) * 1e-6)
    assert program.summarise(evs).spans["xrnerf_torch.nerf.mlp"]["device_s"] == pytest.approx(got)


# --- the per-layer metrics that read the program's spans ---

BENCH = run.load_benchmark(run.ROOT)
SPAN_METRICS = [m for m in BENCH["per_layer"] if m["source"] == "program_span"]
SLICE_SPANS = {  # per span: count, host_s, device_s, idle_s, idle_after_s over a traced slice of 2 steps or frames
    "xrnerf_torch.nerf.sample": (4, 0.010, 0.0560, 0.0150, 0.0260),
    "xrnerf_torch.nerf.encode": (4, 0.004, 0.0448, 0.0090, 0.0110),
    "xrnerf_torch.nerf.mlp": (4, 0.006, 0.6420, 0.0100, 0.0000),
    "xrnerf_torch.nerf.composite": (4, 0.003, 0.0294, 0.0020, 0.0002),
    "xrnerf_torch.render.image": (2, 0.860, 0.0100, 0.0120, 0.0000),
    "xrnerf_torch.render.pad": (2, 0.018, 0.0000, 0.0170, 0.0000),
    "xrnerf_torch.render.h2d": (80, 0.500, 0.0020, 0.0245, 0.0330),
    "xrnerf_torch.render.d2h": (2, 0.040, 0.0110, 0.0050, 0.0160),
    "xrnerf_torch.prefetch.wait": (2, 0.0003, 0.0, 0.0, 0.0),
}
# what these readers read from SLICE_SPANS, per step or frame of a slice of 2: a span's device or host ms, or the
# idle ms after its operations
WANT = {"encode_ms.train": 22.4, "encode_ms.render.nerf": 22.4, "sample_ms.train": 28.0, "sample_ms.render.nerf": 28.0,
        "composite_ms.train": 14.7, "composite_ms.render.nerf": 14.7, "prefetch_wait_ms.train": 0.15,
        "h2d_idle_ms.render.nerf": 16.5, "pad_ms.render.nerf": 9.0}


def cells_of(metric):
    return [w["name"] for w in BENCH["workloads"] if metric in run.reported([metric], w["name"], BENCH["end_to_end"])]


def a_run(cell, spans):
    """A record of ``cell`` with a traced slice of 2 steps or frames whose
    summary carries ``spans`` (False: no traced slice)."""
    _, _, traffic, cfg = run.cell_entries(BENCH, cell)
    summary = SimpleNamespace(program=spans) if spans is not False else None
    return SimpleNamespace(summary=summary, cell=SimpleNamespace(cfg=cfg, traffic=traffic),
                           counters={"slice_steps": 2, "slice_frames": 2})


@pytest.mark.parametrize("metric", SPAN_METRICS, ids=[m["name"] for m in SPAN_METRICS])
def test_a_span_metric_without_its_spans_reads_nothing(metric):
    """Every reader of the program's spans, in each cell that reports it,
    returns None from a record without a traced slice, without the
    program's spans, or without any span."""
    read = run.load_reader(metric["name"])
    assert cells_of(metric)
    for cell in cells_of(metric):
        assert read(a_run(cell, False)) is None
        assert read(a_run(cell, None)) is None
        assert read(a_run(cell, program.ProgramSpans(device_s=1.0, idle_s=0.1))) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_span_metric_reads_its_span(name):
    metric = {m["name"]: m for m in SPAN_METRICS}[name]
    spans = program.ProgramSpans(device_s=1.0, idle_s=0.1, spans={
        k: dict(zip(("count", "host_s", "device_s", "idle_s", "idle_after_s"), v)) for k, v in SLICE_SPANS.items()})
    for cell in cells_of(metric):
        assert run.load_reader(name)(a_run(cell, spans)) == pytest.approx(WANT[name])


# --- whole CPU runs of both cells ---

def with_device_ops(events):
    """The events, and for each leaf ``aten::`` op a device operation linked
    to it, over the same interval (the slice's span left as it is)."""
    by_tid = {}
    for e in events:
        if e.name().startswith("aten::"):
            by_tid.setdefault(e.start_thread_id(), []).append(e)
    out = list(events)
    for ops in by_tid.values():
        ops.sort(key=lambda e: (e.start_ns(), -e.duration_ns()))
        for a, b in zip(ops, ops[1:] + [None]):
            if b is None or b.start_ns() >= a.start_ns() + a.duration_ns():
                dev = Ev(f"kernel:{a.name()}", 0, 0, device=True, linked=a.correlation_id())
                dev._s, dev._d, dev._id = a.start_ns(), max(a.duration_ns(), 1), -1
                out.append(dev)
    return out


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("portbench_cache"))


NERF = [f"xrnerf_torch.nerf.{s}" for s in ("sample", "encode", "mlp", "composite")]
RENDER = [f"xrnerf_torch.render.{s}" for s in ("image", "pad", "h2d", "d2h")]


@pytest.mark.parametrize("cell", ["nerf_blender.render.800", "nerf_blender.train.pool16k"])
def test_spans_of_a_traced_cpu_run(cell, cache, monkeypatch):
    stop = common.Slice.stop

    def stop_with_device_ops(self):
        stop(self)
        self.events = with_device_ops(self.events)

    monkeypatch.setattr(common.Slice, "stop", stop_with_device_ops)
    rec, line, got = tool.traced(cell, 2**31 + 7, 0.2, "cpu", tiny.overrides(cell), cache)
    assert line["correct"]
    per = tool.per_unit(rec, got)
    train = ".train." in cell
    want = NERF + (["xrnerf_torch.prefetch.wait"] if train else RENDER)
    assert sorted(per["spans"]) == sorted(want)
    count = {k: v["count"] for k, v in per["spans"].items()}
    for name in NERF:
        assert count[name] == 2 * (1 if train else count["xrnerf_torch.render.h2d"]), name
    for name in ["xrnerf_torch.prefetch.wait"] if train else ["xrnerf_torch.render.image", "xrnerf_torch.render.pad",
                                                                "xrnerf_torch.render.d2h"]:
        assert count[name] == 1, name
    for v in per["spans"].values():
        assert all(math.isfinite(x) and x >= 0 for x in v.values())
    assert per["mlp_minus_layer_ms"] == pytest.approx(0.0, abs=1e-9)
    assert 0 < per["covered"] <= 1 + 1e-12
    # every span metric of the cell is in its line; those of WANT read what the tool reads from the same spans
    ms = {"encode_ms": ("xrnerf_torch.nerf.encode", "device_ms"),
          "sample_ms": ("xrnerf_torch.nerf.sample", "device_ms"),
          "composite_ms": ("xrnerf_torch.nerf.composite", "device_ms"),
          "prefetch_wait_ms": ("xrnerf_torch.prefetch.wait", "host_ms"),
          "h2d_idle_ms": ("xrnerf_torch.render.h2d", "idle_after_ms"),
          "pad_ms": ("xrnerf_torch.render.pad", "host_ms")}
    for m in SPAN_METRICS:
        if cell not in cells_of(m):
            continue
        got = line["metrics"][m["name"]]["value"]
        assert math.isfinite(got) and got >= 0, m["name"]
        stem = m["name"].split(".")[0]
        if m["name"] in WANT:
            assert got == pytest.approx(per["spans"][ms[stem][0]][ms[stem][1]]), m["name"]
