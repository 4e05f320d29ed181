"""The BungeeNeRF slice of the PyTorch port, held against the JAX package on
the same numpy inputs: ``load/synthetic.py:make_synthetic_blender``,
``BungeeNerfMLP``, ``_stage_composite``, ``BungeeNerfNetwork`` at every
stage (eval outputs, the masked loss, per-leaf loss gradients with bridged
weights), ``BungeeDataset`` in both layouts (scale codes, the pooled rays,
the curriculum stage, eval items), ``load/google.py``, the renderer with a
0-d ``stage`` against the JAX renderer, ``Trainer.run`` across stages with a
checkpoint and a bitwise resume, and the CLI on
``configs/bungeenerf/bungee_multiscale.py`` cut to a small network over a
google-earth layout written to disk.

Tolerances. Both sides are f32: forwards rtol 1e-4 / atol 1e-5, numpy
copies equal; gradients per leaf cosine > 0.999 and norm ratio within 1e-3
of 1 (a locked stage's leaves are zero on both sides).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from test_torch_neuralbody import check_grads, port_grads  # noqa: E402
from xrnerf_torch import build_dataset, build_network, run_nerf  # noqa: E402
from xrnerf_torch.core.trainer import Trainer  # noqa: E402
from xrnerf_torch.datasets.load.synthetic import make_synthetic_blender  # noqa: E402
from xrnerf_torch.models.fields.bungee_mlp import BungeeNerfMLP  # noqa: E402
from xrnerf_torch.models.networks.bungeenerf import _stage_composite  # noqa: E402
from xrnerf_torch.utils import checkpoint as ckpt  # noqa: E402
from xrnerf_torch.utils.weights import jax_params_from_state_dict, state_dict_from_jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
NET_KW = dict(n_stages=3, n_samples=8, netwidth=32, max_deg_point=6)


def _t(a):
    return torch.from_numpy(np.require(np.asarray(a), requirements="C").copy())


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _batch(n=64, stage=1, seed=0):
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    b = {"rays_o": (0.3 * rng.randn(n, 3)).astype(np.float32), "rays_d": d * rng.uniform(0.8, 1.2, (n, 1)),
         "radii": rng.uniform(5e-3, 2e-2, (n, 1)), "near": np.full((n, 1), 1.0), "far": np.full((n, 1), 4.0),
         "target": rng.rand(n, 3), "scale_code": rng.randint(0, 3, (n, 1))}
    b = {k: v.astype(np.float32) for k, v in b.items()}
    if stage is not None:
        b["stage"] = np.asarray(stage, np.int32)
    return b


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A blender-layout sphere scene from the port's maker."""
    out = tmp_path_factory.mktemp("bungee") / "sphere"
    make_synthetic_blender(str(out), n_train=8, n_val=2, n_test=2, H=16, W=16)
    return str(out)


# --- load/synthetic.py ---


def test_make_synthetic_blender_matches_jax(tmp_path):
    import imageio.v2 as imageio

    from xrnerf_tpu.datasets.load.synthetic import make_synthetic_blender as jmake

    kw = dict(n_train=3, n_val=1, n_test=2, H=20, W=24, seed=5)
    a, b = make_synthetic_blender(str(tmp_path / "port"), **kw), jmake(str(tmp_path / "jax"), **kw)
    for split in ("train", "val", "test"):
        with open(os.path.join(a, f"transforms_{split}.json")) as fa, open(
                os.path.join(b, f"transforms_{split}.json")) as fb:
            meta_a, meta_b = json.load(fa), json.load(fb)
        assert meta_a == meta_b
        for frame in meta_a["frames"]:
            ia = imageio.imread(os.path.join(a, frame["file_path"] + ".png"))
            ib = imageio.imread(os.path.join(b, frame["file_path"] + ".png"))
            assert ia.shape == (20, 24, 4) and np.array_equal(ia, ib)


# --- fields / compositing / network ---


def test_bungee_mlp_matches_jax():
    from xrnerf_tpu.models.fields.bungee_mlp import BungeeNerfMLP as JMLP

    rng = np.random.RandomState(1)
    x, v = rng.randn(50, 24).astype(np.float32), rng.randn(50, 11).astype(np.float32)
    jm = JMLP(n_stages=3, netdepth_base=4, netwidth=32, skips=(2,))
    params = jm.init(jax.random.PRNGKey(0), x, v)["params"]
    params = jax.tree_util.tree_map(
        lambda a: (0.1 * rng.randn(*a.shape)).astype(np.float32) if a.ndim == 1 else np.asarray(a), params)
    tm = BungeeNerfMLP(in_ch=24, in_ch_views=11, n_stages=3, netdepth_base=4, netwidth=32, skips=(2,))
    sd = state_dict_from_jax(params)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict({k: _t(w) for k, w in sd.items()})
    got, want = tm(_t(x), _t(v)), jm.apply({"params": params}, x, v)
    assert tuple(got[0].shape) == (50, 3, 3) and tuple(got[1].shape) == (50, 3)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("mask", [(1, 0, 0), (1, 1, 0), (1, 1, 1), (0, 0, 0)])
@pytest.mark.parametrize("white_bkgd", [False, True])
def test_stage_composite_matches_jax(mask, white_bkgd):
    from xrnerf_tpu.models.networks.bungeenerf import _stage_composite as jcomposite

    rng = np.random.RandomState(2)
    n, s = 20, 6
    raw_rgb = rng.randn(n, s, 3, 3).astype(np.float32)
    raw_sigma = (2 * rng.randn(n, s, 3)).astype(np.float32)
    t_vals = np.sort(rng.uniform(1, 4, (n, s + 1)), -1).astype(np.float32)
    rays_d = rng.randn(n, 3).astype(np.float32)
    m = np.asarray(mask, np.float32)
    got = _stage_composite(_t(raw_rgb), _t(raw_sigma), _t(m), _t(t_vals), _t(rays_d), white_bkgd)
    want = jcomposite(raw_rgb, raw_sigma, m, t_vals, rays_d, white_bkgd)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], what=k)
    # a locked stage's raw outputs do not reach the render
    raw_rgb[:, :, 2] += 100.0
    again = _stage_composite(_t(raw_rgb), _t(raw_sigma), _t(m), _t(t_vals), _t(rays_d), white_bkgd)
    assert torch.equal(again["rgb"], got["rgb"]) == (mask[2] == 0)


@pytest.fixture(scope="module")
def bridged():
    from xrnerf_tpu.models.networks.bungeenerf import BungeeNerfNetwork as JB

    jnet = JB(**NET_KW)
    params = jnet.init(jax.random.PRNGKey(0), _batch(8), rng=None, train=False)["params"]
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda a: (0.3 * rng.randn(*a.shape)).astype(np.float32) if a.ndim == 1 else np.asarray(a), params)
    net = build_network(dict(type="BungeeNerfNetwork", **NET_KW), device="cpu")
    net.load_state_dict({k: _t(v) for k, v in state_dict_from_jax(params).items()})
    return jnet, params, net


def test_weights_roundtrip(bridged):
    _, params, net = bridged
    assert set(state_dict_from_jax(params)) == set(net.state_dict())
    back = jax_params_from_state_dict(net.state_dict())
    flat_a, flat_b = jax.tree_util.tree_leaves_with_path(params), jax.tree_util.tree_leaves_with_path(back)
    assert [jax.tree_util.keystr(p) for p, _ in flat_a] == [jax.tree_util.keystr(p) for p, _ in flat_b]
    for (p, a), (_, b) in zip(flat_a, flat_b):
        assert np.array_equal(np.asarray(a), b), jax.tree_util.keystr(p)


@pytest.mark.parametrize("stage", [0, 1, 2, None])
def test_network_eval_and_loss_match_jax(bridged, stage):
    jnet, params, net = bridged
    b = _batch(128, stage=stage, seed=10)
    want = jax.jit(lambda p, bb: jnet.apply({"params": p}, bb, rng=None, train=False))(params, b)
    tb = {k: _t(v) for k, v in b.items()}
    got = net(tb, train=False)
    assert sorted(got) == sorted(want) == ["acc", "coarse_rgb", "depth", "rgb"]
    assert not got["rgb"].requires_grad
    for k in want:
        _close(got[k], want[k], what=k)
    want_loss, want_log = jnet.loss(want, b)
    got_loss, got_log = net.loss({k: _t(np.asarray(v)) for k, v in want.items()}, tb)
    assert sorted(got_log) == sorted(want_log) == ["coarse_mse", "loss", "mse", "psnr"]
    for k in want_log:
        _close(got_log[k], want_log[k], rtol=1e-5, atol=0, what=k)


def test_locked_scales_carry_no_loss(bridged):
    _, _, net = bridged
    b = _batch(16, stage=0, seed=11)
    b["scale_code"][:] = 2.0
    tb = {k: _t(v) for k, v in b.items()}
    loss, _ = net.loss(net(tb, train=False), tb)
    assert float(loss) == 0.0


@pytest.mark.parametrize("stage", [1, None])
def test_network_loss_gradients_match_jax(bridged, stage):
    """The deterministic training path through both levels: the loss and its
    gradients per leaf (stage 1 of 3: the last stage's heads and residual
    block get none, on both sides)."""
    jnet, params, net = bridged
    b = _batch(128, stage=stage, seed=12)

    def jloss(p):
        return jnet.loss(jnet.apply({"params": p}, b, rng=None, train=True), b)[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    net.zero_grad(set_to_none=True)
    tb = {k: _t(v) for k, v in b.items()}
    loss, _ = net.loss(net(tb, generator=None, train=True), tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    zero = not np.any(jg["mlp"]["rgb_s2"]["kernel"])
    assert zero == (stage == 1)
    check_grads(port_grads(net), jg, n_leaves=48)


def test_train_mode_draws_from_generator(bridged):
    _, _, net = bridged
    tb = {k: _t(v) for k, v in _batch(32, seed=13).items()}
    a = net(tb, generator=torch.Generator().manual_seed(0), train=True)["rgb"]
    b = net(tb, generator=torch.Generator().manual_seed(0), train=True)["rgb"]
    c = net(tb, generator=torch.Generator().manual_seed(1), train=True)["rgb"]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(net(tb, None, train=True)["rgb"], net(tb, None, train=True)["rgb"])


# --- datasets/bungee.py, load/google.py ---


@pytest.mark.parametrize("n_stages", [2, 4])
def test_blender_layout_matches_jax(scene, n_stages):
    from xrnerf_tpu.datasets.bungee import BungeeDataset as JDS

    kw = dict(datadir=scene, n_stages=n_stages, iters_per_stage=3, N_rand=32, testskip=1)
    jds, ds = JDS(**kw), build_dataset(dict(type="BungeeDataset", **kw))
    np.testing.assert_array_equal(ds.scale_codes, jds.scale_codes)
    assert ds.scale_codes.dtype == np.int32 and len(set(ds.scale_codes[ds.i_train])) == n_stages
    for k in jds._pool:
        assert np.array_equal(ds._pool[k], jds._pool[k]), k
    np.testing.assert_array_equal(ds._perm, jds._perm)
    for step, host, hosts in ((0, 0, 1), (4, 0, 1), (100, 0, 1), (7, 1, 2)):
        want, got = jds.train_batch(step, host, hosts), ds.train_batch(step, host, hosts)
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.shape(got[k]) == np.shape(want[k]) and np.array_equal(got[k], want[k]), (step, k)
        assert int(got["stage"]) == min(step // 3, n_stages - 1)
    (gr, gt), (wr, wt) = ds.eval_item(int(ds.i_val[0])), jds.eval_item(int(jds.i_val[0]))
    assert np.array_equal(gt, wt) and all(np.array_equal(gr[k], wr[k]) for k in wr)
    (gr, ghw), (wr, whw) = ds.spiral_item(ds.render_poses[5]), jds.spiral_item(jds.render_poses[5])
    assert ghw == whw and all(np.array_equal(gr[k], wr[k]) for k in wr)


def write_google(root, n=8, size=16, seed=0):
    """A multiscale-google layout: ``images/*.png`` and ``poses_enu.json``
    (llff [3, 5] rows + 2 bounds, ``scale_split`` [0, 4, 6])."""
    import imageio.v2 as imageio

    os.makedirs(os.path.join(root, "images"))
    rng = np.random.RandomState(seed)
    poses = []
    for i in range(n):
        imageio.imwrite(os.path.join(root, "images", f"{i:03d}.png"),
                        rng.randint(0, 255, (size, size, 3)).astype(np.uint8))
        p = np.concatenate([np.eye(3, 4), [[size], [size], [12.0]]], axis=1)
        p[:, 3] = [0.0, 0.0, 4.0 - 0.3 * i]  # far to near
        poses.append(np.concatenate([p.reshape(-1), [0, 0]]).tolist())
    with open(os.path.join(root, "poses_enu.json"), "w") as fh:
        json.dump({"poses": poses, "scene_scale": 1.0, "scene_origin": [0, 0, 0], "scale_split": [0, 4, 6]}, fh)
    return str(root)


def test_google_layout_matches_jax(tmp_path):
    from xrnerf_tpu.datasets.bungee import BungeeDataset as JDS
    from xrnerf_tpu.datasets.load.google import _area_downscale as jdown, load_google_data as jload
    from xrnerf_torch.datasets.load.google import _area_downscale, load_google_data

    root = write_google(tmp_path / "google")
    for got, want in zip(load_google_data(root, factor=2), jload(root, factor=2)):
        assert np.array_equal(np.asarray(got), np.asarray(want))
    img = np.random.RandomState(1).rand(13, 11, 3).astype(np.float32)
    for f in (1, 2, 3):
        assert np.array_equal(_area_downscale(img, f), jdown(img, f))
    kw = dict(datadir=root, dataset_type="google", factor=2, N_rand=16, holdout=4, iters_per_stage=10)
    jds, ds = JDS(**kw), build_dataset(dict(type="BungeeDataset", **kw))
    assert ds.n_stages == jds.n_stages == 3
    np.testing.assert_array_equal(ds.scale_codes, [0, 0, 0, 0, 1, 1, 2, 2])
    np.testing.assert_array_equal(ds.i_train, jds.i_train)
    for step in (0, 25):
        want, got = jds.train_batch(step), ds.train_batch(step)
        assert all(np.array_equal(got[k], want[k]) for k in want)
    assert int(ds.train_batch(25)["stage"]) == 2


# --- renderer, Trainer, CLI ---


def test_render_image_with_a_stage_matches_jax(bridged, scene):
    """A 0-d ``stage`` rides with the image's rays: the renderer hands it to
    every chunk whole (256 rays in chunks of 100, the last padded), as the
    JAX renderer does."""
    from xrnerf_tpu.core.renderer import render_image as jrender_image

    jnet, params, net = bridged
    ds = build_dataset(dict(type="BungeeDataset", datadir=scene, n_stages=3, N_rand=32))
    tr = Trainer(net, ds, work_dir=None, eval_chunk=100, device="cpu")
    tr.network.load_state_dict({k: _t(v) for k, v in state_dict_from_jax(params).items()})

    def apply_fn(p, bb, rng):
        return jnet.apply({"params": p}, bb, rng=None, train=False)

    rays, gt = ds.eval_item(int(ds.i_test[0]))
    for stage in (0, 2):
        r = dict(rays, stage=np.asarray(stage, np.int32))
        got = tr.render_image(r, 16, 16)
        want = jrender_image(apply_fn, params, r, 16, 16, chunk=100)
        assert got["rgb"].shape == gt.shape
        for k in ("rgb", "acc"):
            _close(got[k], want[k], what=f"stage {stage} {k}")


def test_trainer_across_stages_and_bitwise_resume(scene, tmp_path):
    """6 steps with 2 steps a stage (stages 0, 1, 2), straight and resumed
    from the checkpoint at step 4: the same parameters bit for bit."""
    ds = build_dataset(dict(type="BungeeDataset", datadir=scene, n_stages=3, iters_per_stage=2, N_rand=32))

    def trainer(wd, max_iters, **kw):
        return Trainer(build_network(dict(type="BungeeNerfNetwork", **NET_KW), device="cpu"), ds,
                       optimizer=dict(type="adam", lr=5e-4), work_dir=str(wd), max_iters=max_iters,
                       ckpt_interval=4, log_interval=2, device="cpu", **kw)

    stages = []

    class Stages:
        def on_run_begin(self, tr): ...

        def on_eval(self, tr, step): ...

        def on_run_end(self, tr): ...

        def after_step(self, tr, step, logs):
            stages.append(tr.dataset.stage_of(step - 1))

    straight = trainer(tmp_path / "a", 6)
    straight.hooks.append(Stages())
    assert straight.run() == 6 and stages == [0, 0, 1, 1, 2, 2]
    trainer(tmp_path / "b", 4).run()
    resumed = trainer(tmp_path / "c", 6, resume_from=ckpt.latest_path(str(tmp_path / "b")))
    assert resumed.start_step == 4 and resumed.run() == 6
    for (k, a), b in zip(straight.network.state_dict().items(), resumed.network.state_dict().values()):
        assert torch.equal(a, b), k


def test_cli_trains_and_tests_bungee(tmp_path):
    """``run_nerf`` trains the narrowed config on a google-earth layout, then
    ``--test_only --load_from`` in a subprocess gives the PSNR the weights
    give in this process."""
    from xrnerf_torch.core.hooks import TestHook

    root = write_google(tmp_path / "google")
    src = open(os.path.join(ROOT, "configs", "bungeenerf", "bungee_multiscale.py")).read()
    cfg = tmp_path / "bungee_cfg.py"
    cfg.write_text(src + f"""
model.update(n_stages=3, n_samples=8, n_resample=8, max_deg_point=4, netwidth=16, iters_per_stage=1)
data.update(datadir=r"{root}", factor=2, holdout=4, n_stages=3, iters_per_stage=1, N_rand=32)
eval_chunk = 64
log_interval = 2
""")
    tr = run_nerf.main(["--config", str(cfg), "--device", "cpu", "--max_iters", "3", "--work_dir",
                        str(tmp_path / "wd")])
    assert tr.step == 3 and np.isfinite(tr.last_logs["loss"]) and tr.dataset.n_stages == 3
    TestHook(save_img=False).on_run_end(tr)
    pt = tmp_path / "w.pt"
    torch.save(tr.network.state_dict(), pt)
    out = subprocess.run(
        [sys.executable, "-m", "xrnerf_torch.run_nerf", "--config", str(cfg), "--device", "cpu", "--test_only",
         "--load_from", str(pt), "--work_dir", str(tmp_path / "test_only")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.load(open(tmp_path / "test_only" / "test" / "test_results.json"))
    assert res["psnr"]["0"] == pytest.approx(tr.eval_metrics["psnr"][0], abs=1e-4)
