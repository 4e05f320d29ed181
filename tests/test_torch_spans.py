"""The port's spans (``xrnerf_torch/utils/spans.py``): while a profiler runs,
vanilla NeRF's network records its stages, the chunked renderer its padding,
per-chunk host-to-device copies and final copy back, and the training loop
its wait for the prefetched batch, nested as the calls nest. With no
profiler no ``record_function`` is made, and the outputs are the same bits
either way."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from xrnerf_torch import build_network  # noqa: E402
from xrnerf_torch.core import hooks as thooks  # noqa: E402
from xrnerf_torch.core.renderer import render_rays_chunked  # noqa: E402
from xrnerf_torch.core.trainer import Trainer  # noqa: E402
from xrnerf_torch.utils import spans  # noqa: E402

STAGES = ("sample", "encode", "mlp", "composite")
CHUNK = 32


def _net(n_importance=8):
    net = build_network(dict(type="NerfNetwork", n_samples=8, n_importance=n_importance, netdepth=2, netwidth=16,
                             multires=4, multires_dirs=2), device="cpu")
    net.reset_parameters(torch.Generator().manual_seed(0))
    return net


def _rays(n, seed):
    rng = np.random.RandomState(seed)
    return {"rays_o": (rng.randn(n, 3) * 0.1 + [0.0, 0.0, 4.0]).astype(np.float32),
            "rays_d": (rng.randn(n, 3) * 0.3 - [0.0, 0.0, 1.0]).astype(np.float32),
            "near": np.full((n, 1), 2.0, np.float32), "far": np.full((n, 1), 6.0, np.float32)}


class Batches:
    """A dataset of random rays and targets, one batch a step."""

    N_rand = 24

    def train_batch(self, step):
        out = _rays(self.N_rand, step)
        out["target"] = np.random.RandomState(1000 + step).rand(self.N_rand, 3).astype(np.float32)
        return out


def _trainer(max_iters, hooks=(), work_dir=None):
    return Trainer(_net(), Batches(), optimizer={"lr": 5e-3}, work_dir=work_dir, max_iters=max_iters,
                   eval_interval=0, ckpt_interval=0, log_interval=10**6, hooks=list(hooks), seed=3, device="cpu")


def _spans(prof):
    """[(name, start, end, thread)] of the program's spans in a profile."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events() if e.name().startswith("xrnerf_torch.")]


def _count(found, name):
    return sum(1 for f in found if f[0] == f"xrnerf_torch.{name}")


@pytest.mark.parametrize("n_importance", [8, 0])
def test_render_spans_count_and_nest(n_importance):
    net, rays = _net(n_importance), _rays(100, 0)  # 100 rays: 4 chunks of 32 after padding
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render_rays_chunked(net, rays, chunk=CHUNK)
    found = _spans(prof)
    chunks, passes = 4, 2 if n_importance else 1
    want = {"render.image": 1, "render.pad": 1, "render.h2d": chunks, "render.d2h": 1,
            "nerf.sample": chunks * passes, "nerf.encode": chunks * passes, "nerf.mlp": chunks * passes,
            "nerf.composite": chunks * passes}
    assert {name: _count(found, name) for name in want} == want
    assert len(found) == sum(want.values())  # no other span
    (_, s0, e0, tid), = [f for f in found if f[0] == "xrnerf_torch.render.image"]
    for name, s, e, t in found:
        assert t == tid and s0 <= s and e <= e0, name
    for mlp in [f for f in found if f[0] == "xrnerf_torch.nerf.mlp"]:  # each MLP call is not inside another stage
        for other in found:
            if other[0].startswith("xrnerf_torch.nerf.") and other is not mlp:
                assert not (other[1] <= mlp[1] and mlp[2] <= other[2]), other[0]


def test_train_spans_count_per_step():
    tr = _trainer(3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tr.run() == 3
    found = _spans(prof)
    want = {"prefetch.wait": 3, **{f"nerf.{s}": 6 for s in STAGES}}
    assert {name: _count(found, name) for name in want} == want
    assert not [f for f in found if f[0].startswith("xrnerf_torch.render.")]


def test_profile_hook_trace_carries_spans(tmp_path):
    tr = _trainer(5, [thooks.ProfileHook(start_step=1, num_steps=2)], str(tmp_path))
    tr.run()
    (name,) = os.listdir(tmp_path / "profile")
    with open(tmp_path / "profile" / name) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("ph") == "X"]
    assert names.count("xrnerf_torch.prefetch.wait") == 2  # the steps between steps 1 and 3
    assert names.count("xrnerf_torch.nerf.mlp") == 4


def test_no_record_function_without_profiler(monkeypatch):
    def refuse(name, *a, **kw):
        raise AssertionError(f"record_function({name!r}) made with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert spans.span("xrnerf_torch.any") is spans.span("xrnerf_torch.other")
    render_rays_chunked(_net(), _rays(40, 1), chunk=CHUNK)
    assert _trainer(2).run() == 2


def test_outputs_are_the_same_bits_with_and_without_a_profiler():
    net, rays = _net(), _rays(70, 2)
    plain = render_rays_chunked(net, rays, chunk=CHUNK)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = render_rays_chunked(net, rays, chunk=CHUNK)
    assert plain.keys() == traced.keys() and all(np.array_equal(plain[k], traced[k]) for k in plain)

    a = _trainer(3)
    a.run()
    b = _trainer(3)
    with profile(activities=[ProfilerActivity.CPU]):
        b.run()
    for (name, pa), pb in zip(a.network.named_parameters(), b.network.parameters()):
        assert torch.equal(pa, pb), name
