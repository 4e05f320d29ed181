"""The check catches a broken timed path: each run here skips the look for a
card and drives the rest of a run on the CPU at a tiny size, with the port
broken underneath, and ``correct`` comes out false. The faults are those a
cell can have: a step that leaves the state unchanged and half of the batch
left out of the loss (training); an answer altered where it is produced (one
chunk of one frame served with its colours inverted; serving). One chip, so
no exchange between chips to leave out. The control, the reference in fp8 in
the port's place, fails the committed limits too."""

from __future__ import annotations

import pytest
import torch

from portbench import run
from portbench.tests import tiny

TRAIN = "nerf_blender.train.pool16k"


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("portbench_cache"))


def checked(cell, cache):
    rec, line = run.run_cell(cell, 987654321, 0.2, False, "cpu", tiny.bench(), tiny.overrides(cell), cache)
    return line


def test_a_step_that_leaves_the_state_unchanged(monkeypatch, cache):
    from xrnerf_torch.core.trainer import Trainer

    orig = Trainer.train_step

    def unchanged(self, batch, step):
        before = [p.detach().clone() for p in self.network.parameters()]
        logs = orig(self, batch, step)
        with torch.no_grad():
            for p, b in zip(self.network.parameters(), before):
                p.copy_(b)
        return logs

    monkeypatch.setattr(Trainer, "train_step", unchanged)
    line = checked(TRAIN, cache)
    assert not line["correct"] and line["checks"]["change_gap"]["value"] > 0.9


def test_half_of_the_batch_left_out(monkeypatch, cache):
    from xrnerf_torch.models.networks.nerf import NerfNetwork

    orig = NerfNetwork.loss

    def half(self, outputs, batch):
        n = batch["target"].shape[0]
        cut = lambda d: {k: v[: n // 2] if v.dim() and v.shape[0] == n else v for k, v in d.items()}  # noqa: E731
        return orig(self, cut(outputs), cut(batch))

    monkeypatch.setattr(NerfNetwork, "loss", half)
    line = checked(TRAIN, cache)
    assert not line["correct"]
    assert line["checks"]["loss_gap"]["value"] > line["checks"]["loss_gap"]["limit"]


@pytest.mark.parametrize("cell,cls", [("nerf_blender.render.800", "xrnerf_torch.models.networks.nerf.NerfNetwork"),
                                      ("ngp_blender.render.800", "xrnerf_torch.models.networks.hashnerf.HashNerfNetwork")])
def test_an_answer_altered_where_it_is_produced(monkeypatch, cache, cell, cls):
    import importlib

    mod, name = cls.rsplit(".", 1)
    net_cls = getattr(importlib.import_module(mod), name)
    orig = net_cls.forward
    calls = {"n": 0}

    def altered(self, batch, generator=None, train=False):
        out = orig(self, batch, generator, train)
        calls["n"] += 1
        if not train and calls["n"] == 5:  # one whole chunk of the window's first frame, its colours inverted
            out = dict(out, rgb=1.0 - out["rgb"])
        return out

    monkeypatch.setattr(net_cls, "forward", altered)
    line = checked(cell, cache)
    assert calls["n"] >= 5
    assert not line["correct"] and line["checks"]["worst_frame_rmse"]["value"] > line["checks"]["worst_frame_rmse"]["limit"]


@pytest.mark.parametrize("cell", ["nerf_blender.train.pool16k", "nerf_blender.render.800", "ngp_blender.render.800"])
def test_the_control_fails_the_limits(cell, cache):
    c = run.make_cell(cell, 24680, 0.1, False, "cpu", tiny.bench(), tiny.overrides(cell), cache)
    drv = run.mix_of(c)
    checks = drv.control(c) if c.traffic["kind"] == "train" else drv.control(c, 4)
    assert any(v > c.limits[k] for k, v in checks.items()), checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["nerf_blender.train.pool16k", "nerf_blender.render.800", "ngp_blender.render.800"])
def test_the_control_fails_the_limits_on_the_card_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = run.make_cell(cell, 13579, 1.0, False, "cuda", tiny.bench())
    drv = run.mix_of(c)
    checks = drv.control(c) if c.traffic["kind"] == "train" else drv.control(c, 40)
    assert any(v > c.limits[k] for k, v in checks.items()), checks
