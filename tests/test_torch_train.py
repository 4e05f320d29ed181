"""The training slice of the PyTorch port, held against the JAX package on the
same numpy inputs: the fused MLP's backward (plain version on the CPU) and
the autograd op around it, the network's train step, the lr schedules and
optimizers, and the Trainer (checkpoints, resume, hooks, EMA, profiling,
the CLI's training path).

Gradients are compared per leaf by direction and size (cosine and norm
ratio), the bars of ``tests/test_fused_nerf_mlp.py``: elementwise bounds
are the wrong metric for bf16 gradients, where a ReLU mask that flips at a
pre-activation near 0 moves single entries.
"""

import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from xrnerf_torch import build_dataset, build_network  # noqa: E402
from xrnerf_torch.core import hooks as thooks  # noqa: E402
from xrnerf_torch.core.trainer import Trainer, build_lr_schedule, build_optimizer  # noqa: E402
from xrnerf_torch.models.fields.nerf_mlp import NerfMLP  # noqa: E402
from xrnerf_torch.ops.fused_nerf_mlp import (  # noqa: E402
    fused_nerf_mlp,
    fused_nerf_mlp_bwd,
    fused_nerf_mlp_bwd_ref,
    fused_nerf_mlp_fwd,
    fused_nerf_mlp_ref,
    pack_params,
    pack_params_f32,
)
from xrnerf_torch.utils import checkpoint as ckpt  # noqa: E402
from xrnerf_torch.utils.weights import jax_params_from_state_dict, nerf_state_dict_from_jax  # noqa: E402


def _cos(a, b):
    a, b = np.ravel(np.asarray(a, np.float64)), np.ravel(np.asarray(b, np.float64))
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _ratio(got, want):
    return float(np.linalg.norm(np.asarray(got)) / (np.linalg.norm(np.asarray(want)) + 1e-30))


def _data(n, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(n, 63).astype(np.float32), rng.randn(n, 27).astype(np.float32)


def _flax_mlp(width, seed):
    from xrnerf_tpu.models.fields.nerf_mlp import NerfMLP as JNerfMLP

    x, v = _data(8, 0)
    params = JNerfMLP(netwidth=width).init(jax.random.PRNGKey(seed), x, v)["params"]
    # small random biases, so no bias starts at an exact zero gradient
    rng = np.random.RandomState(seed)
    return {
        k: {"kernel": np.asarray(p["kernel"]), "bias": (0.1 * rng.randn(*p["bias"].shape)).astype(np.float32)}
        for k, p in params.items()
    }


def _torch_mlp(params, width, fused=True):
    mlp = NerfMLP(netwidth=width, fused=fused)
    mlp.load_state_dict({k: torch.from_numpy(v) for k, v in nerf_state_dict_from_jax(params).items()})
    return mlp


def _grads_by_leaf(mlp):
    return jax_params_from_state_dict({k: p.grad.detach().numpy() for k, p in mlp.named_parameters()})


# --- (a), (b): the op's plain backward against jax.grad through the Pallas kernel ---


def test_fused_op_param_grads_match_jax():
    """Width 256, N = 600 (two JAX backward tiles of 512, ragged)."""
    from xrnerf_tpu.ops.pallas.fused_nerf_mlp import fused_nerf_mlp as jfused

    params = _flax_mlp(256, seed=2)
    x, v = _data(600, seed=3)

    def jloss(p):
        r, s = jfused(jnp.asarray(x), jnp.asarray(v), p)
        return jnp.mean(r**2) + jnp.mean(jax.nn.relu(s) ** 2)

    want = jax.jit(jax.grad(jloss))(params)
    mlp = _torch_mlp(params, 256)
    r, s = mlp(torch.from_numpy(x), torch.from_numpy(v))
    (torch.mean(r**2) + torch.mean(torch.relu(s) ** 2)).backward()
    got = _grads_by_leaf(mlp)
    for name in params:
        for leaf in ("kernel", "bias"):
            g, w = got[name][leaf], np.asarray(want[name][leaf])
            assert _cos(g, w) > 0.99, f"{name}.{leaf}: cos {_cos(g, w)}"
            assert 0.93 < _ratio(g, w) < 1.07, f"{name}.{leaf}: norm ratio {_ratio(g, w)}"


def test_fused_op_input_grads_match_jax():
    from xrnerf_tpu.ops.pallas.fused_nerf_mlp import fused_nerf_mlp as jfused

    params = _flax_mlp(256, seed=5)
    x, v = _data(40, seed=4)

    def f(xx, vv):
        r, s = jfused(xx, vv, params)
        return jnp.sum(r) + jnp.sum(s)

    jdx, jdv = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(v))
    tx, tv = torch.from_numpy(x).requires_grad_(), torch.from_numpy(v).requires_grad_()
    r, s = _torch_mlp(params, 256)(tx, tv)
    (r.sum() + s.sum()).backward()
    assert _cos(tx.grad.numpy(), jdx) > 0.99
    assert _cos(tv.grad.numpy(), jdv) > 0.99
    assert bool((tv.grad != 0).any())


# --- (c): the plain backward against autograd of the plain forward ---


def test_bwd_ref_matches_autograd_of_plain_forward():
    """Same rounding points except where autograd puts them: it carries the
    f32 (not bf16-rounded) dpre into the data-gradient products and rounds
    the gradient flowing through each bf16 cast to bf16. Measured on the
    CPU: cosine >= 0.99998 and max abs error <= 5.3e-3 of the leaf's
    largest entry (dv). Bound: cosine > 0.9999, error <= 2e-2 of the
    largest entry."""
    params = _flax_mlp(256, seed=6)
    sd = {k: torch.from_numpy(a) for k, a in nerf_state_dict_from_jax(params).items()}
    p16 = pack_params(sd, 63, 27)
    # f32 leaves holding the bf16 values, so the plain forward's own
    # .float() of the weights is exact and differentiable
    w = p16.weights.float().requires_grad_()
    b = p16.biases.clone().requires_grad_()
    x, v = (torch.from_numpy(a).requires_grad_() for a in _data(300, seed=7))
    g = torch.from_numpy(np.random.RandomState(8).randn(300, 4).astype(np.float32))
    rgb, sigma = fused_nerf_mlp_ref(x, v, p16._replace(weights=w, biases=b))
    (rgb * g[:, :3]).sum().add((sigma * g[:, 3]).sum()).backward()
    got = fused_nerf_mlp_bwd_ref(x.detach(), v.detach(), g, p16)
    for name, a, want in zip(("dx", "dv", "dw", "db"), got, (x.grad, v.grad, w.grad, b.grad)):
        assert a.shape == want.shape, name
        assert _cos(a, want) > 0.9999, f"{name}: cos {_cos(a, want)}"
        err = float((a - want).abs().max() / want.abs().max())
        assert err <= 2e-2, f"{name}: max abs err {err} of the largest entry"


def test_autograd_op_routes_grads_and_guards_dtype():
    """The op's packing keeps the graph to each nn.Linear; the CPU path
    counts no kernel launch; gradients of unused outputs are zeros; a bf16
    weight buffer is refused."""
    params = _flax_mlp(64, seed=9)
    mlp = _torch_mlp(params, 64)
    x, v = (torch.from_numpy(a) for a in _data(70, seed=10))
    before = (fused_nerf_mlp_fwd.launches, fused_nerf_mlp_bwd.launches)
    rgb, _ = mlp(x, v)
    rgb.sum().backward()  # sigma unused
    assert (fused_nerf_mlp_fwd.launches, fused_nerf_mlp_bwd.launches) == before
    assert all(p.grad is not None for p in mlp.parameters())
    assert float(mlp.alpha.weight.grad.abs().max()) == 0.0  # sigma's head sees no gradient
    pk = pack_params_f32(dict(mlp.named_parameters()), 63, 27)
    assert pk.weights.dtype == torch.float32 and pk.weights.requires_grad
    with pytest.raises(TypeError, match="float32"):
        from xrnerf_torch.ops.fused_nerf_mlp import FusedNerfMLPFunction

        FusedNerfMLPFunction.apply(x, v, pk.weights.to(torch.bfloat16), pk.biases, (64, 63, 27, 64, 32))
    # under inference_mode the cached bf16 pack serves, as before
    with torch.inference_mode():
        r2, _ = mlp(x, v)
    assert not r2.requires_grad
    np.testing.assert_allclose(r2.numpy(), rgb.detach().numpy(), rtol=0, atol=0)


def test_bwd_wrapper_rejects_bad_g():
    params = _flax_mlp(64, seed=11)
    sd = {k: torch.from_numpy(a) for k, a in nerf_state_dict_from_jax(params).items()}
    x, v = (torch.from_numpy(a) for a in _data(5, seed=12))
    with pytest.raises(ValueError, match="g"):
        fused_nerf_mlp_bwd(x, v, torch.zeros(5, 3), pack_params(sd, 63, 27))
    rgb, sigma = fused_nerf_mlp(x, v, sd)
    assert isinstance(rgb, torch.Tensor) and sigma.shape == (5,)


# --- (d): the network's train step against JAX ---


def _net_batch(n, seed):
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return {
        "rays_o": rng.randn(n, 3).astype(np.float32),
        "rays_d": d,
        "near": np.full((n, 1), 2.0, np.float32),
        "far": np.full((n, 1), 6.0, np.float32),
        "target": rng.rand(n, 3).astype(np.float32),
    }


@pytest.mark.parametrize("fused", [False, True])
def test_network_train_step_matches_jax(fused):
    from xrnerf_tpu.models.networks.nerf import NerfNetwork as JNerfNetwork

    kw = dict(n_samples=16, n_importance=16, netdepth=8, netwidth=64, perturb=False, raw_noise_std=0.0, fused=fused)
    batch = _net_batch(128, seed=0)
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    jnet = JNerfNetwork(**kw)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda k: jnet.init(k, jb, rng=None, train=False))(jax.random.PRNGKey(0))["params"]
    )

    def jloss(p):
        out = jnet.apply({"params": p}, jb, rng=jax.random.PRNGKey(7), train=True)
        return jnet.loss(out, jb)[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    net = build_network(dict(type="NerfNetwork", **kw), device="cpu")
    net.load_state_dict({k: torch.from_numpy(a) for k, a in nerf_state_dict_from_jax(params).items()})
    tb = {k: torch.from_numpy(a) for k, a in batch.items()}
    loss, _ = net.loss(net(tb, generator=torch.Generator().manual_seed(7), train=True), tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-3)
    got = jax_params_from_state_dict({k: p.grad.numpy() for k, p in net.named_parameters()})
    for (path, w), (_, g) in zip(jax.tree_util.tree_leaves_with_path(jg), jax.tree_util.tree_leaves_with_path(got)):
        assert _cos(g, w) > 0.97, f"{jax.tree_util.keystr(path)}: cos {_cos(g, w)}"


# --- (e), (f): schedules and optimizers against optax ---


@pytest.mark.parametrize("cfg", [
    {"lr": 5e-4, "lr_decay_steps": 500000, "lr_decay_rate": 0.1},
    {"lr": 5e-4, "lr_final": 5e-6, "max_steps": 500000, "lr_warmup_steps": 2500, "lr_delay_mult": 0.01},
], ids=["exp_decay", "mip_warmup"])
def test_lr_schedule_matches_optax(cfg):
    from xrnerf_tpu.core.trainer import build_lr_schedule as jbuild

    got, want = build_lr_schedule(cfg), jbuild(cfg)
    for step in (0, 1, 100, 499_999):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6), step


# Without clipping the two libraries compute the same update formulas in f32
# (atol 1e-6). With clipping torch scales by max / (norm + 1e-6) and optax by
# max / norm: after three steps the params differ by 3.6e-7 (adam) and 0
# (sgd) on the CPU; the bound is 2e-6.
@pytest.mark.parametrize("opt,clip,atol", [
    ("adam", None, 1e-6), ("adamw", None, 1e-6), ("sgd", None, 1e-6), ("adam", 0.5, 2e-6), ("sgd", 0.5, 2e-6),
])
def test_optimizer_steps_match_optax(opt, clip, atol):
    from xrnerf_tpu.core.trainer import build_optimizer as jbuild

    cfg = {"type": opt, "lr": 1e-2, "lr_decay_steps": 10, "lr_decay_rate": 0.5, "max_steps": 10}
    if clip:
        cfg["grad_clip"] = clip
    rng = np.random.RandomState(0)
    p0 = {"a": rng.randn(7, 5).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in p0.items()} for _ in range(3)]

    tx = jbuild(cfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    optimizer, scheduler, grad_clip = build_optimizer(list(tp.values()), cfg)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        if grad_clip:
            torch.nn.utils.clip_grad_norm_(list(tp.values()), grad_clip)
        optimizer.step()
        scheduler.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=atol, rtol=0, err_msg=k)


def test_build_optimizer_rejects_unknown_type():
    with pytest.raises(ValueError, match="unknown optimizer"):
        build_optimizer([torch.nn.Parameter(torch.zeros(1))], {"type": "nope"})


# --- (g): the Trainer on the synthetic scene (tests/test_trainer.py mirrored) ---


def _tiny(synthetic_scene, **net_kw):
    ds = build_dataset(dict(type="SceneDataset", datadir=synthetic_scene, N_rand=64, testskip=1, white_bkgd=True))
    kw = dict(n_samples=8, n_importance=0, netdepth=2, netwidth=32, multires=4, multires_dirs=2)
    kw.update(net_kw)
    return ds, build_network(dict(type="NerfNetwork", **kw), device="cpu")


def _trainer(ds, net, work_dir, **kw):
    args = dict(optimizer={"lr": 5e-3}, work_dir=str(work_dir), ckpt_interval=0, log_interval=5, device="cpu")
    args.update(kw)
    return Trainer(net, ds, **args)


def test_trainer_runs_and_checkpoints(synthetic_scene, tmp_path):
    ds, net = _tiny(synthetic_scene)
    tr = _trainer(ds, net, tmp_path, max_iters=12, ckpt_interval=10)
    assert tr.run() == 12
    assert tr.last_logs["loss"] > 0 and tr.last_logs["rays_per_sec"] > 0
    assert ckpt.all_steps(str(tmp_path)) == [10, 12]
    assert ckpt.latest_path(str(tmp_path)).endswith("ckpt_12.pt")

    # resume continues from the saved step
    tr2 = _trainer(ds, net, tmp_path, max_iters=14, resume_from=ckpt.latest_path(str(tmp_path)))
    assert tr2.start_step == 12
    assert tr2.run() == 14


def test_checkpoint_keeps_last_three(tmp_path):
    for step in range(1, 6):
        ckpt.save(str(tmp_path), step, {"step": step})
    assert ckpt.all_steps(str(tmp_path)) == [3, 4, 5]
    assert ckpt.load(ckpt.latest_path(str(tmp_path)))["step"] == 5
    assert not glob.glob(str(tmp_path / "*.tmp"))


def test_trainer_eval_hooks(synthetic_scene, tmp_path):
    ds, net = _tiny(synthetic_scene)
    tr = _trainer(ds, net, tmp_path, max_iters=4, eval_interval=4, log_interval=2, eval_chunk=256,
                  hooks=[thooks.ValidateHook(save_img=True, max_images=1), thooks.TestHook(save_img=False)])
    tr.run()
    assert "psnr" in tr.eval_metrics
    assert os.path.exists(tmp_path / "test" / "test_results.json")
    assert glob.glob(str(tmp_path / "val_4" / "*.png"))


def test_trainer_kill_switch(synthetic_scene, tmp_path):
    ds, net = _tiny(synthetic_scene)

    class StopAt(thooks.OccupationHook):
        def after_step(self, t, step, logs):
            if step == 3:
                os.rmdir(os.path.join(t.work_dir, self.marker))
            super().after_step(t, step, logs)

    tr = _trainer(ds, net, tmp_path, max_iters=1000, log_interval=1000, hooks=[StopAt()])
    assert tr.run() == 3


def test_ema_params(synthetic_scene, tmp_path):
    ds, net = _tiny(synthetic_scene)
    tr = _trainer(ds, net, tmp_path, optimizer={"lr": 5e-2}, max_iters=3, log_interval=10, ema_decay=0.9)
    tr.run()
    w_ema, w_raw = tr.eval_params["mlp_coarse.pts_0.weight"], tr.network.mlp_coarse.pts_0.weight
    assert tr.eval_network is tr.ema_network
    assert not torch.allclose(w_ema, w_raw.detach())


def test_profile_hook(synthetic_scene, tmp_path):
    ds, net = _tiny(synthetic_scene, n_samples=4, netwidth=16, multires=2)
    tr = _trainer(ds, net, tmp_path, max_iters=5, log_interval=100, hooks=[thooks.ProfileHook(start_step=2, num_steps=2)])
    tr.run()
    prof = tmp_path / "profile"
    assert prof.is_dir() and len(os.listdir(prof)) > 0


def test_resume_is_deterministic(synthetic_scene, tmp_path):
    """4 straight steps equal 2 steps, a resume, and 2 more: each step's
    random draws (jitter, pdf samples, density noise) come from (seed,
    step), and the checkpoint holds the optimizer and schedule."""
    kw = dict(n_importance=8, raw_noise_std=1.0)
    ds, net = _tiny(synthetic_scene, **kw)
    a = _trainer(ds, net, tmp_path / "a", max_iters=4)
    a.run()
    ds, net = _tiny(synthetic_scene, **kw)
    _trainer(ds, net, tmp_path / "b", max_iters=2, ckpt_interval=2).run()
    ds, net = _tiny(synthetic_scene, **kw)
    b = _trainer(ds, net, tmp_path / "b", max_iters=4, resume_from=str(tmp_path / "b" / "ckpt_2.pt"))
    assert b.run() == 4
    for (k, pa), (_, pb) in zip(a.network.state_dict().items(), b.network.state_dict().items()):
        np.testing.assert_allclose(pb.numpy(), pa.numpy(), atol=1e-7, rtol=0, err_msg=k)


# --- (h): the CLI's training path ---


def test_cli_trains(synthetic_scene, tmp_path):
    from xrnerf_torch import run_nerf

    cfg = tmp_path / "cfg.py"
    cfg.write_text(
        f"""
max_iters = 100
log_interval = 2
ckpt_interval = 100
eval_interval = 4
eval_chunk = 256
model = dict(type="NerfNetwork", n_samples=4, n_importance=4, netdepth=2, netwidth=16,
             multires=2, multires_dirs=1)
data = dict(type="SceneDataset", datadir=r"{synthetic_scene}", N_rand=32, testskip=1)
optimizer = dict(type="adam", lr=5e-4, lr_decay_steps=500000, lr_decay_rate=0.1)
hooks = [dict(type="ValidateHook", save_img=False, max_images=1), dict(type="OccupationHook")]
"""
    )
    tr = run_nerf.main(["--config", str(cfg), "--device", "cpu", "--max_iters", "4", "--work_dir", str(tmp_path / "wd")])
    assert tr.step == 4 and "psnr" in tr.eval_metrics
    assert ckpt.all_steps(str(tmp_path / "wd")) == [4]
    assert isinstance(tr.optimizer, torch.optim.Adam)
