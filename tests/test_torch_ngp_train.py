"""The Instant-NGP training slice of the PyTorch port against the JAX
package, at a small size, on the same numpy inputs: the row scatter-add, the
gradients of both hash encodings, the network's loss gradients leaf by leaf
in both parameter layouts and both hash layouts, and ``Trainer.run`` with
the occupancy grid's refresh cadence, the EMA copy's grid, resume and the
CLI.

On the CPU the port's scatter is its plain version (``index_add_``); the JAX
package's Pallas scatter runs in interpret mode as in ``tests/test_ngp.py``.
Tolerances: the scatter and the encodings are f32 on both sides and differ
only in summation order (rtol 1e-5 and 1e-4 of the gradient's scale);
network gradients pass through bf16 MLPs whose ReLU masks and roundings flip
singly, and are held per leaf to cosine > 0.99 and norm ratio 0.93-1.07 (the
JAX package's fused-MLP bars).

The CUDA scatter kernel has no CPU or interpret mode; its test carries the
``cuda`` marker and runs on the card with
``XRNERF_TEST_TPU=1 python -m pytest tests/test_torch_ngp_train.py -m cuda``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from xrnerf_torch import build_dataset  # noqa: E402
from xrnerf_torch.core.trainer import Trainer  # noqa: E402
from xrnerf_torch.models.embedders.hashenc import (  # noqa: E402
    BrickHashEncoding,
    HashEncoding,
    _corner_weights,
)
from xrnerf_torch.models.networks.hashnerf import HashNerfNetwork  # noqa: E402
from xrnerf_torch.ops.scatter_rows import scatter_add_rows, scatter_add_rows_plain  # noqa: E402
from xrnerf_torch.utils.weights import (  # noqa: E402
    grid_state_from_jax,
    jax_params_from_state_dict,
    state_dict_from_jax,
)

FIELD_KW = dict(n_levels=4, n_features=2, log2_table_size=10, base_res=4, max_res=32, hidden_dim=64, geo_feat_dim=15)
NET_KW = dict(FIELD_KW, n_cascades=1, grid_res=16, n_candidates=64, n_keep=16, grid_update_samples=512)
ENC_KW = dict(n_levels=4, n_features=2, log2_table_size=10, base_res=4, max_res=32)  # res 4, 8, 16 (hashed), 32 (hashed)
N_RAYS = 192


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --- (b) the row scatter-add --------------------------------------------------


def _scatter_case(n, w, rows, seed, dead=0.0, negative=0.0):
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, rows, size=(n,)).astype(np.int32)
    vals = rng.randn(n, w).astype(np.float32)
    vals[rng.uniform(size=n) < dead] = 0.0
    idx[rng.uniform(size=n) < negative] = -1
    return idx, vals


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("n,w,rows", [(2048 + 37, 16, 64), (1000, 2, 300), (1024, 2, 8), (5, 16, 64)])
def test_scatter_plain_matches_pallas_and_xla(n, w, rows, skip):
    import jax.numpy as jnp

    from xrnerf_tpu.ops.pallas import scatter_rows as jsr

    idx, vals = _scatter_case(n, w, rows, seed=n + w, dead=0.3, negative=0.2)
    flagged = np.where((vals != 0).any(-1), idx, -1) if skip else idx  # the JAX wrapper's flagging (:198-200)
    want_pallas = np.asarray(jsr._pallas_scatter_add_rows(jnp.asarray(flagged), jnp.asarray(vals), rows, interpret=True))
    # XLA's scatter wraps a negative id to the last rows (its callers flag only all-zero rows),
    # so it gets the dropped rows' values zeroed
    zeroed = np.where(idx[:, None] >= 0, vals, 0.0).astype(np.float32)
    want_xla = np.asarray(jsr.scatter_add_rows(jnp.asarray(idx), jnp.asarray(zeroed), rows, skip_zero_rows=skip))
    for dtype in (torch.int32, torch.int64):
        got = scatter_add_rows_plain(_t(idx).to(dtype), _t(vals), rows, skip_zero_rows=skip)
        assert got.shape == (rows, w) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want_pallas, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), want_xla, rtol=1e-5, atol=1e-5)
    # on CPU tensors the wrapper is the plain version and launches nothing
    before = scatter_add_rows.launches
    assert torch.equal(scatter_add_rows(_t(idx), _t(vals), rows, skip_zero_rows=skip), got)
    assert scatter_add_rows.launches == before


def test_scatter_drops_what_it_should():
    idx = torch.tensor([0, -1, 2, 2, -5], dtype=torch.int64)
    vals = torch.tensor([[1.0, 2.0], [10.0, 10.0], [0.0, 0.0], [3.0, 0.0], [7.0, 7.0]])
    out = scatter_add_rows(idx, vals, 4)
    assert out.tolist() == [[1.0, 2.0], [0.0, 0.0], [3.0, 0.0], [0.0, 0.0]]
    assert torch.equal(scatter_add_rows(idx, vals, 4, skip_zero_rows=True), out)
    with pytest.raises(ValueError, match=r"idx \[N\]"):
        scatter_add_rows(idx[:3], vals, 4)
    with pytest.raises(TypeError, match="int32 or int64"):
        scatter_add_rows(idx.float(), vals, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("w,rows,skip", [(2, 524_288, False), (2, 64, False), (16, 4096, True), (3, 100, True), (8, 100, False)])
def test_cuda_scatter_kernel_matches_plain_version(w, rows, skip):
    """f32 atomics add in another order every run: rtol 1e-4, atol 1e-4 of
    the largest row sum. A failure prints the worst element."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    for n in (1, 127, 1000, 70001):
        idx, vals = _scatter_case(n, w, rows, seed=n, dead=0.5 if skip else 0.0, negative=0.2)
        for dtype in (torch.int32, torch.int64):
            ci, cv = _t(idx).to(dtype).cuda(), _t(vals).cuda()
            before = scatter_add_rows.launches
            got = scatter_add_rows(ci, cv, rows, skip_zero_rows=skip)
            torch.cuda.synchronize()
            assert scatter_add_rows.launches == before + 1
            want = scatter_add_rows_plain(ci, cv, rows, skip_zero_rows=skip)
            err = (got - want).abs()
            bar = 1e-4 * float(want.abs().max()) + 1e-4 * want.abs()
            at = int(torch.argmax(err - bar))
            assert bool((err <= bar).all()), (
                f"N={n} W={w} rows={rows} {dtype}: element {at} is {float(got.flatten()[at])}, "
                f"plain {float(want.flatten()[at])}, max abs err {float(err.max())}")


# --- (c) the vertex encoding's gradients ----------------------------------------


def _vertex_pair(seed=0, n=301):
    rng = np.random.RandomState(seed)
    table = rng.uniform(-1.0, 1.0, (4, 1 << 10, 2)).astype(np.float32)
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    c = rng.randn(n, 8).astype(np.float32)
    enc = HashEncoding(**ENC_KW)
    with torch.no_grad():
        enc.table.copy_(_t(table))
    return enc, table, x, c


def _old_forward(enc, x):
    """The encoding as one differentiable chain of torch ops (gather by
    ``index_select``, trilerp): autograd's gradients are the reference."""
    idx, t = enc._corner_cells(x)
    w8 = _corner_weights(t, dim=1)
    outs = []
    for lvl in range(enc.n_levels):
        feats = enc.table[lvl].index_select(0, idx[lvl].reshape(-1)).view(8, x.shape[0], enc.n_features)
        outs.append((feats * w8[lvl][..., None]).sum(dim=0))
    return torch.stack(outs, dim=1).reshape(x.shape[0], -1)


def test_vertex_gradients_match_jax_and_autograd():
    import jax
    import jax.numpy as jnp

    from xrnerf_tpu.models.embedders import hashenc as jhash

    enc, table, x, c = _vertex_pair()
    res, T = enc.resolutions, enc.table_size
    assert [r**3 <= T for r in res] == [True, True, False, False]  # dense and hashed levels
    cfg = (res, T, 2)
    jt, jx = jax.grad(lambda tb, xx: jnp.sum(jhash._vertex_lookup(tb, xx, cfg) * jnp.asarray(c)), argnums=(0, 1))(
        jnp.asarray(table), jnp.asarray(x)
    )
    xt = _t(x).requires_grad_()
    (enc(xt) * _t(c)).sum().backward()
    gt, gx = enc.table.grad.clone(), xt.grad.clone()
    for got, want in ((gt, jt), (gx, jx)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    assert float(gt[0, 4**3:].abs().max()) == 0.0 and float(gt[0, : 4**3].abs().min()) > 0  # a dense level's rows

    enc.table.grad = None
    xo = _t(x).requires_grad_()
    (_old_forward(enc, xo) * _t(c)).sum().backward()
    np.testing.assert_allclose(gt.numpy(), enc.table.grad.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gx.numpy(), xo.grad.numpy(), rtol=1e-4, atol=1e-3)


def test_vertex_backward_skips_what_is_not_asked():
    enc, _, x, c = _vertex_pair(seed=1, n=40)
    before = scatter_add_rows.launches
    (enc(_t(x)) * _t(c)).sum().backward()  # x needs no gradient
    assert enc.table.grad is not None and scatter_add_rows.launches == before
    enc.table.requires_grad_(False)
    xt = _t(x).requires_grad_()
    (enc(xt) * _t(c)).sum().backward()
    assert xt.grad is not None
    with torch.inference_mode():
        assert enc(_t(x)).shape == (40, 8)


# --- (d) the brick encoding ------------------------------------------------------


@pytest.mark.parametrize("n_lattices,blend", [(1, "mean"), (2, "mean"), (2, "smooth"), (1, "smooth"), (3, "mean")])
def test_brick_encoding_matches_jax(n_lattices, blend):
    import jax
    import jax.numpy as jnp

    from xrnerf_tpu.models.embedders import hashenc as jhash

    kw = dict(n_levels=4, n_features=2, log2_table_size=12, base_res=4, max_res=32, n_lattices=n_lattices, blend=blend)
    jenc, enc = jhash.BrickHashEncoding(**kw), BrickHashEncoding(**kw)
    rng = np.random.RandomState(n_lattices)
    tb = (1 << 9) // n_lattices
    assert enc.table.shape == (4, n_lattices, tb, 16) and enc.rows == tb
    table = rng.uniform(-1.0, 1.0, enc.table.shape).astype(np.float32)
    x = rng.uniform(0.0, 1.0, (257, 3)).astype(np.float32)
    x[:3] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5]]
    c = rng.randn(257, 8).astype(np.float32)
    with torch.no_grad():
        enc.table.copy_(_t(table))
    for k in range(n_lattices):  # row indices, exactly; dense and hashed levels both occur
        jidx, jt = jhash._brick_cells(jnp.asarray(x), (enc.resolutions, tb), k)
        idx, t = enc._brick_cells(_t(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-7)
    dense = [(r - 1) ** 3 <= tb for r in enc.resolutions]
    assert any(dense) and not all(dense)

    def f(tbl, xx):
        return jenc.apply({"params": {"table": tbl}}, xx)

    want = np.asarray(f(jnp.asarray(table), jnp.asarray(x)))
    jt, jx = jax.grad(lambda tbl, xx: jnp.sum(f(tbl, xx) * jnp.asarray(c)), argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x))
    xt = _t(x).requires_grad_()
    got = enc(xt)
    assert got.shape == (257, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    (got * _t(c)).sum().backward()
    for g, w in ((enc.table.grad, jt), (xt.grad, jx)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
    assert list(enc.state_dict()) == ["table"]
    with pytest.raises(ValueError, match="blend"):
        BrickHashEncoding(blend="cubic")


# --- (e) the network's loss gradients, leaf by leaf --------------------------------


def _batch(n=N_RAYS, seed=0):
    rng = np.random.RandomState(seed)
    o = (0.5 + rng.uniform(-1.5, 1.5, (n, 3))).astype(np.float32)
    d = ((0.5 + rng.uniform(-0.4, 0.4, (n, 3))) - o).astype(np.float32)
    return {"rays_o": o, "rays_d": d, "target": rng.uniform(size=(n, 3)).astype(np.float32),
            "alpha": rng.uniform(size=(n, 1)).astype(np.float32)}


def _randomise(params, seed):
    """Seeded numpy values in a flax tree's shapes: a table of order 1,
    lecun-scaled weights, small biases, and +2 on the raw density."""
    import jax

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
    field = out["field"]
    if "d_b2" in field:
        field["d_b2"][0] += 2.0
    else:
        field["density_net"]["layers_2"]["bias"][0] += 2.0
    return out


def _jax_net(fused, **kw):
    """The JAX network; ``fused`` swaps in ``NGPField(use_pallas=True)``, which
    the JAX network itself never builds."""
    from xrnerf_tpu.models.fields.ngp_mlp import NGPField as JField
    from xrnerf_tpu.models.networks.hashnerf import HashNerfNetwork as JNet

    if not fused:
        return JNet(**NET_KW, **kw)

    class JFusedNet(JNet):
        def setup(self):
            self.field = JField(
                **FIELD_KW, use_pallas=True, hash_layout=self.hash_layout, n_lattices=self.n_lattices,
                brick_blend=self.brick_blend, dtype=self.dtype,
            )

    return JFusedNet(**NET_KW, **kw)


@pytest.mark.parametrize("budget", [0, 700], ids=["all", "compacted"])
@pytest.mark.parametrize("layout", ["vertex", "brick"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_network_loss_gradients_match_jax(fused, layout, budget):
    import jax
    import jax.numpy as jnp

    from xrnerf_tpu.models.samplers import occupancy as jocc

    kw = dict(sample_budget=budget, hash_layout=layout, n_lattices=2 if layout == "brick" else 1)
    batch = _batch(seed=11)
    rng = np.random.RandomState(12)
    bits = rng.uniform(size=(1, 16**3)) < 0.12
    dens = np.where(bits, 0.02, 0.0).astype(np.float32)
    jgrid = jocc.OccupancyGrid(jnp.asarray(dens), jnp.asarray(bits))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jnet = _jax_net(fused, **kw)
    params = jnet.init(jax.random.PRNGKey(0), {k: v[:8] for k, v in jb.items()}, rng=None, train=False)["params"]
    params = _randomise(jax.tree_util.tree_map(np.asarray, params), seed=13)

    def jloss(p):
        out = jnet.apply({"params": p}, jb, rng=None, train=True, aux=jgrid)  # no rng: a deterministic march
        return jnet.loss(out, jb)[0]

    want_loss, jgrads = jax.value_and_grad(jloss)(params)

    net = HashNerfNetwork(**NET_KW, fused=fused, **kw)
    sd = {**state_dict_from_jax(params), **grid_state_from_jax((dens, bits))}
    net.load_state_dict({k: _t(v) for k, v in sd.items()})
    tb = {k: _t(v) for k, v in batch.items()}
    out = net(tb, generator=None, train=True)
    live = int(out["n_live_samples"])
    assert 700 < live < N_RAYS * 16  # the budget of 700 drops live samples
    loss, _ = net.loss(out, tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=2e-2)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))  # the weights' name map, on gradients
    got = {k: p.grad for k, p in net.named_parameters()}
    assert sorted(got) == sorted(want) and len(got) == 11
    for k, w in want.items():
        a, b = got[k].double().flatten(), _t(w).double().flatten()
        cos = float(a @ b / (a.norm() * b.norm() + 1e-30))
        ratio = float(a.norm() / (b.norm() + 1e-30))
        assert cos > 0.99 and 0.93 < ratio < 1.07, (k, cos, ratio)
    # the brick table [L, n_lat, tb, 8F] goes back to the flax tree it came from
    back = jax_params_from_state_dict(net.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)
    if layout == "brick":
        assert got["field.encoding.table"].shape == (4, 2, (1 << 7) // 2, 16)


# --- (f) Trainer.run on an NGP network ---------------------------------------------


def _ngp_trainer(synthetic_scene, work_dir, **kw):
    ds = build_dataset(dict(type="HashNerfDataset", datadir=synthetic_scene, N_rand=64, testskip=1))
    net = HashNerfNetwork(**dict(NET_KW, sample_budget=900), fused=True)
    args = dict(optimizer=dict(type="adam", lr=1e-2, eps=1e-15, beta1=0.9, beta2=0.99), work_dir=str(work_dir),
                ckpt_interval=0, log_interval=8, seed=5, ema_decay=0.95, device="cpu")
    args.update(kw)
    return Trainer(net, ds, **args)


def test_trainer_refreshes_the_grid_and_keeps_the_ema_grid(synthetic_scene, tmp_path):
    tr = _ngp_trainer(synthetic_scene, tmp_path, max_iters=34)
    calls = []
    update_aux = tr.network.update_aux

    def spy(generator=None, draws=None):
        calls.append((tr.step, generator.initial_seed(), tr.network.grid_density.clone()))
        return update_aux(generator, draws)

    tr.network.update_aux = spy
    assert tr.run() == 34
    assert [c[0] for c in calls] == [0, 16, 32]  # before steps 0, 16 and 32
    assert [c[1] for c in calls] == [5 * 2**32 + 2**31 + s for s in (0, 16, 32)]  # its own stream, not the step's
    assert not torch.equal(calls[1][2], calls[2][2])  # a refresh changes the grid
    assert torch.equal(tr.ema_network.grid_density, tr.network.grid_density)
    assert torch.equal(tr.ema_network.grid_bitfield, tr.network.grid_bitfield)
    assert tr.eval_network is tr.ema_network
    assert not torch.equal(tr.ema_network.field.d_w1, tr.network.field.d_w1.detach())  # EMA weights, live grid
    assert not bool(tr.network.grid_bitfield[tr.network.grid_density < 0].any())
    assert np.isfinite(tr.last_logs["loss"]) and 0 < tr.last_logs["live_frac"] <= 1
    rays, gt = tr.dataset.eval_item(int(tr.dataset.i_test[0]))
    assert np.isfinite(tr.render_image(rays, *gt.shape[:2])["rgb"]).all()


def test_trainer_ema_grid_follows_a_stale_checkpoint(synthetic_scene, tmp_path):
    """An EMA state saved with another grid than the model's renders with the model's."""
    tr = _ngp_trainer(synthetic_scene, tmp_path, max_iters=2)
    tr.run()
    tr.ema_network.grid_bitfield.zero_()
    path = tr.save_checkpoint(2)
    again = _ngp_trainer(synthetic_scene, tmp_path, max_iters=2, resume_from=path)
    assert torch.equal(again.ema_network.grid_bitfield, tr.network.grid_bitfield)
    assert bool(again.ema_network.grid_bitfield.any())


@pytest.mark.parametrize("at", [16, 19])
def test_resumed_ngp_run_equals_a_straight_run(synthetic_scene, tmp_path, at):
    """22 straight steps against ``at`` steps, a resume, and the rest, bit for
    bit: the refresh before step 16 falls before (at=19) or after (at=16)
    the checkpoint, and its draws come from (seed, 2**31 + 16) either way."""
    a = _ngp_trainer(synthetic_scene, tmp_path / "a", max_iters=22)
    a.run()
    _ngp_trainer(synthetic_scene, tmp_path / "b", max_iters=at, ckpt_interval=at).run()
    b = _ngp_trainer(synthetic_scene, tmp_path / "b", max_iters=22, resume_from=str(tmp_path / "b" / f"ckpt_{at}.pt"))
    assert b.start_step == at and b.run() == 22
    for net_a, net_b in ((a.network, b.network), (a.ema_network, b.ema_network)):
        for (k, pa), (_, pb) in zip(net_a.state_dict().items(), net_b.state_dict().items()):
            assert torch.equal(pa, pb), k


def test_cli_trains_ngp(synthetic_scene, tmp_path):
    from xrnerf_torch import run_nerf
    from xrnerf_torch.utils import checkpoint as ckpt

    cfg = tmp_path / "cfg.py"
    cfg.write_text(
        f"""
max_iters = 100
log_interval = 2
ckpt_interval = 100
eval_interval = 4
eval_chunk = 200
ema_decay = 0.95
model = dict(type="HashNerfNetwork", n_levels=4, log2_table_size=10, base_res=4, max_res=32,
             grid_res=16, n_candidates=64, n_keep=16, sample_budget=2048, fused=True)
data = dict(type="HashNerfDataset", datadir=r"{synthetic_scene}", N_rand=64, testskip=1)
optimizer = dict(type="adam", lr=1e-2, eps=1e-15, beta1=0.9, beta2=0.99, lr_decay_steps=20000, lr_decay_rate=0.33)
hooks = [dict(type="ValidateHook", save_img=False, max_images=1),
         dict(type="SampleBudgetHook", target_samples=2**8, buckets=(16, 32, 128))]
"""
    )
    tr = run_nerf.main(["--config", str(cfg), "--device", "cpu", "--max_iters", "4", "--work_dir", str(tmp_path / "wd")])
    assert tr.step == 4 and np.isfinite(tr.eval_metrics["psnr"])  # ValidateHook rendered through the EMA copy
    assert tr.dataset.N_rand in (16, 32, 128)  # SampleBudgetHook moved the batch while run prefetched
    assert ckpt.all_steps(str(tmp_path / "wd")) == [4]
    assert torch.equal(tr.ema_network.grid_density, tr.network.grid_density)
    state = ckpt.load(ckpt.latest_path(str(tmp_path / "wd")))
    assert torch.equal(state["ema"]["grid_bitfield"], state["model"]["grid_bitfield"])
