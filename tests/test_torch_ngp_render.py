"""The Instant-NGP serving slice of the PyTorch port as a whole, against the
JAX package, at a small size (4 levels, table 2^10, grid 16^3, 64 candidates,
keep 16): the network in both parameter layouts with weights and grid carried
across by ``utils/weights.py``, the grid's lifecycle with the same random
draws, the loss, checkpoints that keep the grid, and the CLI on the CPU.

Tolerances. The unfused layout computes its MLPs in bf16 on both sides, and
the fused layout rounds to bf16 at the same points on both sides; what
differs is accumulation order, which flips single bf16 roundings (one part
in 256 of a hidden value). Composited maps are held to 2e-2 absolute
(rgb, acc, depth in cube units, weights); live-sample counts and masks are
equal exactly. With ``dtype=float32`` the bars are 1e-5.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xrnerf_tpu.models.fields.ngp_mlp import NGPField as JField  # noqa: E402
from xrnerf_tpu.models.networks.hashnerf import HashNerfNetwork as JNet  # noqa: E402
from xrnerf_tpu.models.samplers import ngp_march as jmarch  # noqa: E402
from xrnerf_tpu.models.samplers import occupancy as jocc  # noqa: E402

from xrnerf_torch import build_dataset, build_network  # noqa: E402
from xrnerf_torch.core.renderer import render_image  # noqa: E402
from xrnerf_torch.core.trainer import Trainer  # noqa: E402
from xrnerf_torch.models.networks.hashnerf import HashNerfNetwork  # noqa: E402
from xrnerf_torch.models.samplers.occupancy import GridDraws, OccupancyGrid  # noqa: E402
from xrnerf_torch.utils import checkpoint as ckpt  # noqa: E402
from xrnerf_torch.utils.weights import (  # noqa: E402
    grid_state_from_jax,
    jax_grid_from_state_dict,
    jax_params_from_state_dict,
    state_dict_from_jax,
)

ATOL = 2e-2  # bf16 paths, see the module docstring
FIELD_KW = dict(n_levels=4, n_features=2, log2_table_size=10, base_res=4, max_res=32, hidden_dim=64, geo_feat_dim=15)
NET_KW = dict(FIELD_KW, n_cascades=1, grid_res=16, n_candidates=64, n_keep=16, grid_update_samples=512)
N_RAYS = 192


def _batch(n=N_RAYS, seed=0):
    rng = np.random.RandomState(seed)
    o = (0.5 + rng.uniform(-1.5, 1.5, (n, 3))).astype(np.float32)
    d = ((0.5 + rng.uniform(-0.4, 0.4, (n, 3))) - o).astype(np.float32)
    return {"rays_o": o, "rays_d": d, "target": rng.uniform(size=(n, 3)).astype(np.float32),
            "alpha": rng.uniform(size=(n, 1)).astype(np.float32)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _randomise(params, seed):
    """Seeded numpy values in a flax tree's shapes: a table of order 1, so
    the encoding (and with it the density) varies over the cube, lecun-scaled
    weights, small biases, and +2 on the raw density."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = np.shape(x)
        if name == "table":
            return rng.uniform(-1, 1, shape).astype(np.float32)
        if len(shape) == 2:
            return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    out = jax.tree_util.tree_map_with_path(leaf, params)
    field = out.get("field", out)
    if "d_b2" in field:
        field["d_b2"][0] += 2.0
    else:
        field["density_net"]["layers_2"]["bias"][0] += 2.0
    return out


def _grid_np(seed=1, res=16, live=0.12):
    rng = np.random.RandomState(seed)
    bits = rng.uniform(size=(1, res**3)) < live
    return np.where(bits, 0.02, 0.0).astype(np.float32), bits


def _jax_net(dtype=jnp.bfloat16, **kw):
    net = JNet(**NET_KW, dtype=dtype, **kw)
    params = net.init(jax.random.PRNGKey(0), _jb(_batch(8)), rng=None, train=False)["params"]
    return net, _randomise(jax.tree_util.tree_map(np.asarray, params), seed=2)


def _port_net(params, grid, prefix="", **kw):
    net = HashNerfNetwork(**NET_KW, **kw)
    sd = {**state_dict_from_jax(params, prefix=prefix), **grid_state_from_jax(grid)}
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return net


def _same_maps(got, want, atol):
    for k in ("rgb", "acc", "depth", "weights"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=atol, err_msg=k)
    assert int(got["n_live_samples"]) == int(want["n_live_samples"])


# (a) the network, unfused layout; a budget that does not bite, and one that does
@pytest.mark.parametrize("budget", [0, 2048, 700])
def test_network_unfused_matches_jax(budget):
    batch = _batch()
    dens, bits = _grid_np()
    jnet, params = _jax_net(sample_budget=budget)
    want = jnet.apply({"params": params}, _jb(batch), rng=None, train=False,
                      aux=jocc.OccupancyGrid(jnp.asarray(dens), jnp.asarray(bits)))
    net = _port_net(params, (dens, bits), sample_budget=budget, fused=False)
    got = net(_tb(batch))
    live = int(got["n_live_samples"])
    assert 700 < live < 2048 < N_RAYS * 16  # 700 drops live samples, 2048 drops only dead ones
    assert sorted(got) == sorted(want)
    _same_maps(got, want, ATOL)
    assert 0.05 < float(got["acc"].mean()) < 0.95 and float(got["rgb"].std()) > 0.02
    if budget == 2048:  # nothing live was dropped: the same picture as without a budget
        free = _port_net(params, (dens, bits), sample_budget=0, fused=False)(_tb(batch))
        assert all(torch.equal(got[k], free[k]) for k in got)
    if budget == 700:
        free = _port_net(params, (dens, bits), sample_budget=0, fused=False)(_tb(batch))
        assert float((got["acc"] - free["acc"]).abs().max()) > 1e-3


def test_network_float32_matches_jax_tightly():
    batch = _batch(seed=3)
    dens, bits = _grid_np(seed=4)
    jnet, params = _jax_net(dtype=jnp.float32, sample_budget=900)
    want = jnet.apply({"params": params}, _jb(batch), rng=None, train=False,
                      aux=jocc.OccupancyGrid(jnp.asarray(dens), jnp.asarray(bits)))
    got = _port_net(params, (dens, bits), sample_budget=900, fused=False, dtype=torch.float32)(_tb(batch))
    _same_maps(got, want, 1e-5)


# (b) the fused layout: JAX march + NGPField(use_pallas=True) + composite
def test_network_fused_matches_jax_pallas_field():
    batch = _batch(seed=5)
    dens, bits = _grid_np(seed=6)
    jgrid = jocc.OccupancyGrid(jnp.asarray(dens), jnp.asarray(bits))
    field = JField(**FIELD_KW, use_pallas=True)
    fparams = field.init(jax.random.PRNGKey(0), jnp.zeros((4, 3)), jnp.ones((4, 3)))["params"]
    fparams = _randomise(jax.tree_util.tree_map(np.asarray, fparams), seed=7)
    m = jmarch.march_rays(None, jnp.asarray(batch["rays_o"]), jnp.asarray(batch["rays_d"]), jgrid,
                          n_candidates=64, n_keep=16, res=16)
    raw_rgb, raw_sigma = field.apply({"params": fparams}, m.pts.reshape(-1, 3), jnp.repeat(m.dirs, 16, axis=0))
    want = jmarch.composite_masked(raw_rgb.reshape(N_RAYS, 16, 3), raw_sigma.reshape(N_RAYS, 16), m)
    want["n_live_samples"] = jnp.sum(m.mask)

    net = _port_net(fparams, (dens, bits), prefix="field.", fused=True)
    assert sorted(n for n, _ in net.field.named_parameters()) == sorted(
        ["encoding.table"] + [f"{p}{i}" for p in ("d_w", "d_b") for i in (1, 2)] + [f"{p}{i}" for p in ("c_w", "c_b") for i in (1, 2, 3)]
    )
    got = net(_tb(batch))
    _same_maps(got, want, ATOL)
    # and through the compaction: the same picture while nothing live is dropped
    tight = _port_net(fparams, (dens, bits), prefix="field.", fused=True, sample_budget=int(got["n_live_samples"]))
    assert all(torch.equal(v, got[k]) for k, v in tight(_tb(batch)).items())
    # the weights go back to the flax tree they came from
    back = jax_params_from_state_dict(net.state_dict())["field"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, fparams)


def test_weights_round_trip_unfused():
    _, params = _jax_net()
    dens, bits = _grid_np()
    net = _port_net(params, (dens, bits), fused=False)
    assert net.field.density_net[0].weight.shape == (64, 8) and net.field.color_net[4].weight.shape == (3, 64)
    jax.tree_util.tree_map(np.testing.assert_array_equal, jax_params_from_state_dict(net.state_dict()), params)
    d2, b2 = jax_grid_from_state_dict(net.state_dict())
    np.testing.assert_array_equal(d2, dens)
    np.testing.assert_array_equal(b2, bits)


# (c) the grid's lifecycle with the JAX package's draws
def test_init_aux_and_update_aux_match_jax(synthetic_scene):
    ds = build_dataset(dict(type="HashNerfDataset", datadir=synthetic_scene, N_rand=64, testskip=1))
    jnet, params = _jax_net(dtype=jnp.float32)
    net = HashNerfNetwork(**NET_KW, dtype=torch.float32)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict_from_jax(params).items()}, strict=False)
    jgrid = jnet.init_aux(params, ds)
    tgrid = net.init_aux(ds)
    np.testing.assert_array_equal(tgrid.density.numpy(), np.asarray(jgrid.density))
    assert 0.02 < float((tgrid.density < 0).float().mean()) < 0.98 and bool(tgrid.bitfield.all())

    n_u = n_b = 256
    cells = 16**3
    for step in range(4):
        key = jax.random.PRNGKey(10 + step)
        k1, k2, k3, _ = jax.random.split(key, 4)
        total = int((np.asarray(jgrid.density) > 0.0).sum())
        draws = GridDraws(
            uni_cells=torch.from_numpy(np.array(jax.random.randint(k1, (n_u,), 0, cells)).astype(np.int64)),
            rank=torch.from_numpy(np.array(jax.random.randint(k2, (n_b,), 1, max(total, 1) + 1)).astype(np.int64)),
            fallback_cells=torch.from_numpy(np.array(jax.random.randint(k2, (n_b,), 0, cells)).astype(np.int64)),
            jitter=torch.from_numpy(np.array(jax.random.uniform(k3, (n_u + n_b, 3)))),
        )
        jgrid = jnet.update_aux(params, jgrid, jnp.asarray(16 * step), key)
        tgrid = net.update_aux(draws=draws)
        np.testing.assert_array_equal(tgrid.bitfield.numpy(), np.asarray(jgrid.bitfield))  # exactly
        np.testing.assert_allclose(tgrid.density.numpy(), np.asarray(jgrid.density), rtol=1e-5, atol=1e-9)
    assert 0 < int(tgrid.bitfield.sum()) < cells
    assert not bool(tgrid.bitfield[tgrid.density < 0].any())  # untrained cells stay dead
    assert torch.equal(net.grid_density, tgrid.density) and torch.equal(net.state_dict()["grid_bitfield"], tgrid.bitfield)
    # the port's own draws: a refresh changes the grid and keeps untrained cells
    before = net.grid_density.clone()
    net.update_aux(torch.Generator().manual_seed(0))
    assert not torch.equal(net.grid_density, before) and bool((net.grid_density[before < 0] == -1).all())


# (d) the loss and its logs
def test_loss_matches_jax():
    batch = _batch(seed=8)
    dens, bits = _grid_np(seed=9)
    jnet, params = _jax_net()
    net = _port_net(params, (dens, bits), fused=False)
    out = net(_tb(batch), generator=torch.Generator().manual_seed(0), train=True)
    loss, logs = net.loss(out, _tb(batch))
    jout = {k: jnp.asarray(v.detach().numpy()) for k, v in out.items()}
    jloss, jlogs = jnet.loss(jout, _jb(batch))
    assert sorted(logs) == sorted(jlogs) == ["acc_err", "live_frac", "loss", "mse", "psnr"]
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for k in jlogs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=1e-5, err_msg=k)
    loss.backward()  # the CPU path is differentiable, down to the table
    assert float(net.field.encoding.table.grad.abs().sum()) > 0
    no_alpha = {k: v for k, v in _tb(batch).items() if k != "alpha"}
    assert "acc_err" not in net.loss(out, no_alpha)[1]


def test_brick_layout_and_fused_defaults():
    with pytest.raises(NotImplementedError, match="BrickHashEncoding"):
        HashNerfNetwork(**NET_KW, hash_layout="brick")
    net = build_network(dict(type="HashNerfNetwork", **NET_KW), device="cpu")
    assert net.fused is False and net.aux_interval == 16 and hasattr(net.field, "density_net")
    net.reset_parameters(torch.Generator().manual_seed(0))
    tb = net.field.encoding.table
    assert float(tb.abs().max()) <= 1e-4 and float(net.field.density_net[0].bias.abs().max()) == 0
    w = net.field.color_net[2].weight
    assert abs(float(w.std()) - 1 / 8) < 0.02 and float(w.abs().max()) <= 2 / 8 / 0.8796 + 1e-6
    fused = HashNerfNetwork(**NET_KW, fused=True)
    fused.reset_parameters(torch.Generator().manual_seed(0))
    assert fused.field.d_w1.shape == (8, 64) and abs(float(fused.field.c_w2.std()) - 1 / 8) < 0.02
    assert float(fused.field.c_b3.abs().max()) == 0


# (e) checkpoints and weight files keep the grid
def test_checkpoint_round_trip_keeps_grid(synthetic_scene, tmp_path):
    ds = build_dataset(dict(type="HashNerfDataset", datadir=synthetic_scene, N_rand=64, testskip=1))

    def trainer(**kw):
        return Trainer(HashNerfNetwork(**NET_KW, fused=True), ds, work_dir=str(tmp_path), seed=0, device="cpu",
                       eval_chunk=300, **kw)

    tr = trainer(ema_decay=0.9)
    fresh = tr.network.grid_density.clone()
    assert bool((fresh < 0).any())  # init_aux ran at construction, with the dataset's cameras
    assert torch.equal(tr.ema_network.grid_density, fresh)
    with torch.no_grad():
        tr.network.field.encoding.table.mul_(1e4)
    for i in range(3):
        tr.network.update_aux(torch.Generator().manual_seed(i))
    assert not torch.equal(tr.network.grid_density, fresh)
    path = tr.save_checkpoint(7)
    assert ckpt.all_steps(str(tmp_path)) == [7]

    again = trainer(resume_from=path)
    assert again.start_step == 7
    assert torch.equal(again.network.grid_density, tr.network.grid_density)
    assert torch.equal(again.network.grid_bitfield, tr.network.grid_bitfield)

    pt = tmp_path / "w.pt"
    torch.save(tr.network.state_dict(), pt)
    loaded = trainer(load_from=str(pt), ema_decay=0.9)
    assert torch.equal(loaded.eval_network.grid_bitfield, tr.network.grid_bitfield)  # EMA copy included
    rays, gt = ds.eval_item(int(ds.i_test[0]))
    a = loaded.render_image(rays, *gt.shape[:2])
    b = render_image(tr.network, rays, *gt.shape[:2], chunk=300)
    assert sorted(a) == ["acc", "rgb"] and a["rgb"].shape == gt.shape  # no disp from this network
    c = render_image(tr.network, rays, *gt.shape[:2], chunk=300, keys=("rgb", "depth"))
    assert c["depth"].shape == gt.shape[:2] and float(c["depth"].max()) > 0
    np.testing.assert_array_equal(a["rgb"], b["rgb"])
    # the march goes through the network's grid: an empty one leaves nothing live
    t_rays = {k: torch.from_numpy(v[:50]) for k, v in rays.items()}
    assert int(tr.network(t_rays)["n_live_samples"]) > 0
    tr.network.set_grid(OccupancyGrid(tr.network.grid_density, torch.zeros_like(tr.network.grid_bitfield)))
    assert int(tr.network(t_rays)["n_live_samples"]) == 0


# (f) the CLI on the CPU
def _ngp_cfg(tmp_path, synthetic_scene):
    cfg = tmp_path / "cfg.py"
    cfg.write_text(
        f"""
eval_chunk = 200
ema_decay = 0.95
model = dict(type="HashNerfNetwork", n_levels=4, log2_table_size=10, base_res=4, max_res=32,
             grid_res=16, n_candidates=64, n_keep=16, sample_budget=2048, fused=True)
data = dict(type="HashNerfDataset", datadir=r"{synthetic_scene}", N_rand=64, testskip=1)
optimizer = dict(type="adam", lr=1e-2, eps=1e-15, beta1=0.9, beta2=0.99)
hooks = [dict(type="ValidateHook", save_img=False, max_images=1),
         dict(type="SampleBudgetHook", target_samples=2**10)]
"""
    )
    return cfg


def test_cli_test_only_and_render_only(synthetic_scene, tmp_path):
    from xrnerf_torch import run_nerf
    from xrnerf_torch.core.hooks import SampleBudgetHook, SaveSpiralHook, ValidateHook

    cfg = _ngp_cfg(tmp_path, synthetic_scene)
    ds = build_dataset(dict(type="HashNerfDataset", datadir=synthetic_scene, N_rand=64, testskip=1))
    src = Trainer(HashNerfNetwork(**dict(NET_KW, sample_budget=2048), fused=True), ds, work_dir=None, seed=3, device="cpu")
    with torch.no_grad():
        src.network.field.encoding.table.mul_(1e4)
        src.network.field.d_b2[0] = 2.0
    for i in range(4):
        src.network.update_aux(torch.Generator().manual_seed(i))
    pt = tmp_path / "w.pt"
    torch.save(src.network.state_dict(), pt)

    wd = tmp_path / "wd"
    tr = run_nerf.main(["--config", str(cfg), "--device", "cpu", "--test_only", "--load_from", str(pt),
                        "--work_dir", str(wd)])
    assert [type(h) for h in tr.hooks] == [ValidateHook, SampleBudgetHook]
    assert torch.equal(tr.eval_network.grid_bitfield, src.network.grid_bitfield)
    res = json.load(open(wd / "test" / "test_results.json"))
    assert np.isfinite(res["psnr"]["0"]) and os.path.exists(wd / "test" / f"test_{len(ds.i_test) - 1}.png")
    rays, gt = ds.eval_item(int(ds.i_test[0]))
    want = render_image(src.network, rays, *gt.shape[:2], chunk=200)["rgb"]
    np.testing.assert_array_equal(tr.render_image(rays, *gt.shape[:2])["rgb"], want)
    assert want.std() > 0.01  # the grid and the field shape the picture

    tr = run_nerf.main(["--config", str(cfg), "--device", "cpu", "--render_only", "--load_from", str(pt),
                        "--work_dir", str(wd)])
    assert [p for p in os.listdir(wd) if p.startswith("spiral_0.")]
    hook = SaveSpiralHook(n_frames=2, save_img=False)
    hook.on_eval(tr, 0)
    assert len(hook.frames) == 2 and hook.frames[0].shape == (ds.H, ds.W, 3)
    ValidateHook(save_img=False, max_images=1).on_eval(tr, 0)
    assert np.isfinite(tr.eval_metrics["psnr"])
