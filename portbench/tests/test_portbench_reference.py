"""The reference agrees with the port on the CPU at a tiny size of each
configuration, through the port's plain f32 paths (``fused=False``; the NGP
field in float32): the whole run's check reads next to nothing."""

from __future__ import annotations

import pytest
import torch

from portbench import run
from portbench.families import ngp as fngp
from portbench.reference import ngp as rngp
from portbench.tests import tiny


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("portbench_cache"))


@pytest.mark.parametrize("cell,limit", [("nerf_blender.train.pool16k", 1e-3), ("nerf_blender.render.800", 1e-5),
                                        ("ngp_blender.render.800", 1e-4)])
def test_check_reads_little_on_the_plain_path(cell, limit, cache):
    rec, line = run.run_cell(cell, 2**31 + 12345, 0.2, False, "cpu", tiny.bench(), tiny.overrides(cell), cache)
    assert line["correct"] and rec.attempted >= 1 and rec.failed == 0
    assert all(v < limit for v in rec.checks.values()), rec.checks
    assert set(line["metrics"]) >= {"setup_s"} and list(line)[-1] == "checks"


def test_ngp_grid_matches_the_reference(cache):
    """The grid that init_aux and update_aux derive (plain f32 field) is the
    one the reference derives from the same weights and draws."""
    from xrnerf_torch.core.trainer import Trainer

    cell = run.make_cell("ngp_blender.render.800", 7, 0.1, False, "cpu", tiny.bench(),
                         tiny.overrides("ngp_blender.render.800"), cache)
    net = fngp.build(cell.cfg, "cpu")
    tr = Trainer(net, fngp.cameras(cell.cfg, cell.traffic), work_dir=None, ckpt_interval=0, seed=7, device="cpu")
    weights = fngp.make_weights(cell.cfg, 7, "cpu")
    fngp.load(tr.network, weights)
    served = fngp.prepare_serving(tr, cell.cfg, cell.traffic, 7)
    want = fngp.reference_grid(weights, cell.cfg, cell.traffic, 7, lambda t: t, "cpu")
    assert 0 < int(want.sum()) < want.numel()
    assert int((want != served["bitfield"]).sum()) <= max(1, int(want.sum()) // 200)


def test_ngp_reference_marches_as_the_port():
    """Occupied candidates and kept samples of the reference's march equal
    the port's march_rays on the same grid."""
    from xrnerf_torch.models.samplers.ngp_march import march_rays
    from xrnerf_torch.models.samplers.occupancy import OccupancyGrid

    m = tiny.overrides("ngp_blender.render.800")["cfg"]["model"]
    g = torch.Generator().manual_seed(3)
    bits = torch.rand(m["grid_res"] ** 3, generator=g) < 0.3
    o = torch.rand((500, 3), generator=g) * 0.2 - 0.5
    d = 1.0 - o * 2 + torch.rand((500, 3), generator=g) * 0.1
    grid = OccupancyGrid(torch.zeros(1, bits.numel()), bits[None])
    got = march_rays(None, o, d, grid, n_candidates=m["n_candidates"], n_keep=m["n_keep"], res=m["grid_res"])
    kept = rngp.kept_per_ray(bits, m, o, d)
    assert torch.equal(got.mask.sum(-1), kept)
    assert 0 < int(kept.sum()) < kept.numel() * m["n_keep"]


def test_ngp_rays_that_the_grids_march_differently_are_left_out(cache):
    """Served frames marched through a grid with some cells flipped: the
    rays whose candidates or budget the flips change are left out, and the
    rest read the reference's rgb exactly."""
    import numpy as np

    from portbench.lib import rays as lrays

    cell = run.make_cell("ngp_blender.render.800", 11, 0.1, False, "cpu", tiny.bench(),
                         tiny.overrides("ngp_blender.render.800"), cache)
    cfg, t = cell.cfg, cell.traffic
    w = fngp.make_weights(cfg, 11, "cpu")
    q = fngp.reference_rounding(cfg)
    bits = fngp.reference_grid(w, cfg, t, 11, q, "cpu")
    flipped = bits.clone()
    flipped[torch.nonzero(bits)[::7, 0]] = False
    rays = fngp.frame_rays(cfg, t, lrays.orbit(t["poses"])[0])
    frames = [{"pose": 0, "idx": np.arange(t["size"] ** 2), "rays": rays}]
    served = fngp.render_frames(w, cfg, frames, flipped, fngp._befores(flipped, cfg, frames, lambda k: rays, "cpu"), q, "cpu")
    frames[0]["rgb"] = served[0].numpy()
    ref = fngp.reference_frames(w, cfg, t, 11, {"bitfield": flipped, "frames": frames, "pose_rays": lambda k: rays}, "cpu")
    keep, diff = ref["keep"][0], (served[0] - ref["rgb"][0]).abs().amax(-1)
    assert 0 < ref["info"]["rays_left_out"] < 0.9 and ref["checks"]["grid_cells_differ"] > 0.1
    assert float(diff[keep].max()) == 0.0 and float(diff[~keep].max()) > 1e-2


def test_the_backward_rounding_rounds_the_products_of_the_backward():
    """``fp8_backward``: the forward is float32's, the gradients those of
    fp8 cotangents and operands; the bias's the sum of the cotangent."""
    import torch.nn.functional as F

    from portbench.reference import lowp

    g = torch.Generator().manual_seed(5)
    x, w, b = (torch.randn(s, generator=g).requires_grad_(True) for s in ((64, 32), (16, 32), (16,)))
    y = lowp.linear(x, w, b, lowp.rounding("fp8_backward"))
    assert torch.allclose(y, F.linear(x, w, b), rtol=1e-6, atol=1e-6)
    gy = torch.randn(y.shape, generator=g)
    gx, gw, gb = torch.autograd.grad(y, (x, w, b), gy)
    r = lowp._fp8
    assert torch.allclose(gx, r(gy) @ r(w.detach()), rtol=1e-6, atol=1e-6)
    assert torch.allclose(gw, r(gy).t() @ r(x.detach()), rtol=1e-6, atol=1e-6)
    assert torch.allclose(gb, gy.sum(0)) and not torch.allclose(gx, gy @ w.detach(), rtol=1e-3, atol=1e-3)
