"""The AniNeRF slice of the PyTorch port, held against the JAX package on the
same numpy inputs: the skinning utilities of ``models/networks/utils/lbs.py``
(``closest_vertex``, ``sample_blend_weights``, ``batch_rodrigues``,
``get_rigid_transformation`` on SMPL's kinematic tree, ``pose_to_tpose`` /
``tpose_to_pose``), ``BlendWeightMLP``, ``TPoseHuman``, ``AniNeRFDataset``,
``AniNeRFNetwork`` in both phases (eval outputs, loss, per-leaf loss
gradients with bridged weights), the Trainer's ``trainable_filter``
(``novel_pose`` trains only ``novel_pose_bw_mlp.*``, bit for bit, from a
``train_pose`` checkpoint through ``load_from``; against the JAX trainer's
masked optimizer), the weights bridge both ways, and the CLI on both
``configs/aninerf/`` configs cut to a small network.

Tolerances. Both sides are f32: forwards rtol 1e-4 / atol 1e-5, discrete
outputs equal; gradients per leaf cosine > 0.999 and norm ratio within 1e-3
of 1.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import xrnerf_tpu.models.networks.utils.lbs as jlbs  # noqa: E402
import xrnerf_torch.models.networks.utils.lbs as tlbs  # noqa: E402
from test_torch_neuralbody import check_grads, port_grads, write_zju  # noqa: E402
from xrnerf_torch import build_dataset, build_network, run_nerf  # noqa: E402
from xrnerf_torch.core.trainer import Trainer  # noqa: E402
from xrnerf_torch.datasets.load.synthetic import make_synthetic_zju  # noqa: E402
from xrnerf_torch.models.networks.aninerf import AniNeRFNetwork, BlendWeightMLP, TPoseHuman  # noqa: E402
from xrnerf_torch.utils import checkpoint as ckpt  # noqa: E402
from xrnerf_torch.utils.weights import jax_params_from_state_dict, state_dict_from_jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
SMPL_PARENTS = np.array([-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21])
NET_KW = dict(n_joints=3, num_frames=4, n_samples=8, hidden=32, smpl_dist_threshold=0.2)


def _t(a):
    return torch.from_numpy(np.require(np.asarray(a), requirements="C").copy())


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def ani_arrays(n_frames=2, n_cams=3, H=20, W=20, n_verts=100, seed=3):
    """``make_synthetic_zju`` plus 3 joints (parents -1, 0, 1 as in SMPL's
    table), blend weights that fall with the distance to each joint, and
    seeded poses (so A is not the identity)."""
    arr = make_synthetic_zju(n_frames=n_frames, n_cams=n_cams, H=H, W=W, n_verts=n_verts)
    rng = np.random.RandomState(seed)
    arr["joints"] = np.array([[0.0, 0.0, 0.0], [0.15, 0.0, 0.0], [0.0, 0.15, 0.05]], np.float32)
    arr["parents"] = np.array([-1, 0, 1])
    d = np.linalg.norm(arr["verts"][0][:, None] - arr["joints"][None], axis=-1)
    w = np.exp(-d / 0.1)
    arr["weights"] = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    arr["poses"] = (0.3 * rng.randn(n_frames, 3, 3)).astype(np.float32)
    return arr


@pytest.fixture(scope="module")
def arrays():
    return ani_arrays()


# --- models/networks/utils/lbs.py ---


def test_closest_vertex_matches_jax():
    rng = np.random.RandomState(0)
    verts = rng.randn(150, 3).astype(np.float32) * 0.3
    verts[7] = verts[3]  # a tie: both packages take the first
    pts = (rng.randn(500, 3) * 0.4).astype(np.float32)
    pts[0] = verts[3]
    idx, d2 = tlbs.closest_vertex(_t(pts), _t(verts))
    jidx, jd2 = jlbs.closest_vertex(jnp.asarray(pts), jnp.asarray(verts))
    np.testing.assert_array_equal(_np(idx), np.asarray(jidx))
    assert int(idx[0]) == 3 and float(d2[0]) == 0.0
    _close(d2, jd2, rtol=1e-6, atol=1e-7)
    wbw = rng.rand(150, 5).astype(np.float32)
    bw, dist = tlbs.sample_blend_weights(_t(pts), _t(verts), _t(wbw))
    jbw, jdist = jlbs.sample_blend_weights(jnp.asarray(pts), jnp.asarray(verts), jnp.asarray(wbw))
    np.testing.assert_array_equal(_np(bw), np.asarray(jbw))
    _close(dist, jdist, rtol=1e-6, atol=1e-7)


def test_batch_rodrigues_matches_jax():
    rng = np.random.RandomState(1)
    rv = (rng.randn(24, 3) * 0.7).astype(np.float32)
    rv[0] = 0.0  # no rotation: the 1e-8 guard
    rv[1] = [0.0, 0.0, np.pi / 2]
    got = tlbs.batch_rodrigues(_t(rv))
    _close(got, jlbs.batch_rodrigues(jnp.asarray(rv)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(got)[1] @ np.array([1.0, 0, 0]), [0, 1, 0], atol=1e-6)


def test_get_rigid_transformation_matches_jax():
    """SMPL's 24-joint tree (the root's parent -1 is never read), numpy in
    and out as the dataset calls it, tensors in and out too."""
    rng = np.random.RandomState(2)
    joints = (rng.randn(24, 3) * 0.3).astype(np.float32)
    poses = (rng.randn(24, 3) * 0.4).astype(np.float32)
    got = tlbs.get_rigid_transformation(poses, joints, SMPL_PARENTS)
    assert isinstance(got, np.ndarray) and got.shape == (24, 4, 4)
    want = np.asarray(jlbs.get_rigid_transformation(jnp.asarray(poses), jnp.asarray(joints), SMPL_PARENTS))
    _close(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[:, 3], np.tile([0, 0, 0, 1.0], (24, 1)))
    as_tensor = tlbs.get_rigid_transformation(_t(poses), _t(joints), SMPL_PARENTS)
    assert isinstance(as_tensor, torch.Tensor) and np.array_equal(_np(as_tensor), got)
    rest = tlbs.get_rigid_transformation(np.zeros((24, 3), np.float32), joints, SMPL_PARENTS)
    _close(rest, np.broadcast_to(np.eye(4), (24, 4, 4)), rtol=0, atol=1e-6)


def test_skinning_both_ways_matches_jax():
    rng = np.random.RandomState(3)
    joints = (rng.randn(4, 3) * 0.2).astype(np.float32)
    A = tlbs.get_rigid_transformation((0.3 * rng.randn(4, 3)).astype(np.float32), joints, [-1, 0, 1, 2])
    pts = rng.randn(60, 3).astype(np.float32)
    bw = rng.rand(60, 4).astype(np.float32)
    bw /= bw.sum(-1, keepdims=True)
    jA, jpts, jbw = jnp.asarray(A), jnp.asarray(pts), jnp.asarray(bw)
    posed = tlbs.tpose_to_pose(_t(pts), _t(bw), _t(A))
    _close(posed, jlbs.tpose_to_pose(jpts, jbw, jA), rtol=1e-5, atol=1e-6)
    back = tlbs.pose_to_tpose(posed, _t(bw), _t(A))
    _close(back, jlbs.pose_to_tpose(jnp.asarray(_np(posed)), jbw, jA), rtol=1e-5, atol=1e-5)
    _close(back, pts, rtol=0, atol=1e-4)
    # a singular blend (all-zero weights) neither raises nor syncs: non-finite, as in JAX
    z = np.zeros((2, 4), np.float32)
    assert not np.isfinite(_np(tlbs.pose_to_tpose(_t(pts[:2]), _t(z), _t(A)))).all()
    assert not np.isfinite(np.asarray(jlbs.pose_to_tpose(jpts[:2], jnp.asarray(z), jA))).all()


# --- the fields ---


def _bridge(jmod, args, port, seed):
    params = jmod.init(jax.random.PRNGKey(seed), *args)["params"]
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: (0.1 * rng.randn(*a.shape)).astype(np.float32) if a.ndim == 1 else np.asarray(a), params)
    port.load_state_dict({k: _t(v) for k, v in state_dict_from_jax(params).items()})
    return params


def test_blend_weight_mlp_matches_jax():
    from xrnerf_tpu.models.networks.aninerf import BlendWeightMLP as JBW

    rng = np.random.RandomState(4)
    pts = rng.randn(40, 3).astype(np.float32)
    sbw = rng.rand(40, 5).astype(np.float32)
    fidx = np.asarray(1, np.int32)
    jm = JBW(n_joints=5, num_frames=3, latent_dim=8, hidden=16, depth=2)
    tm = BlendWeightMLP(n_joints=5, num_frames=3, latent_dim=8, hidden=16, depth=2)
    params = _bridge(jm, (pts, sbw, fidx), tm, 0)
    got = tm(_t(pts), _t(sbw), _t(fidx))
    _close(got, jm.apply({"params": params}, pts, sbw, fidx))
    _close(got.sum(-1), np.ones(40), rtol=0, atol=1e-6)


def test_tpose_human_matches_jax():
    from xrnerf_tpu.models.networks.aninerf import TPoseHuman as JTH

    rng = np.random.RandomState(5)
    tpts, dirs = rng.randn(40, 3).astype(np.float32), rng.randn(40, 3).astype(np.float32)
    fidx = np.asarray(2, np.int32)
    jm, tm = JTH(num_frames=3, hidden=16, depth=2), TPoseHuman(num_frames=3, hidden=16, depth=2)
    params = _bridge(jm, (tpts, dirs, fidx), tm, 1)
    for g, w in zip(tm(_t(tpts), _t(dirs), _t(fidx)), jm.apply({"params": params}, tpts, dirs, fidx)):
        _close(g, w)


# --- datasets/aninerf.py ---


@pytest.fixture(scope="module")
def datasets(arrays):
    from xrnerf_tpu.datasets.aninerf import AniNeRFDataset as JDS

    kw = dict(N_rand=16, training_view=(0, 1))
    return JDS(arrays=arrays, **kw), build_dataset(dict(type="AniNeRFDataset", arrays=arrays, **kw))


def test_dataset_matches_jax(datasets):
    jds, ds = datasets
    assert ds.A.shape == (2, 3, 4, 4) and ds.A.dtype == np.float32
    _close(ds.A, jds.A, rtol=1e-6, atol=1e-6)
    assert not np.allclose(ds.A[0], np.eye(4), atol=1e-3)
    for step in (0, 1, 5):
        want, got = jds.train_batch(step), ds.train_batch(step)
        assert sorted(got) == sorted(want) and "ctx_A" in got and "ctx_bw_verts" in got
        for k in want:
            if k == "ctx_A":
                _close(got[k], want[k], rtol=1e-6, atol=1e-6)
            else:
                assert np.shape(got[k]) == np.shape(want[k]) and np.array_equal(got[k], want[k]), k
    (gr, gt), (wr, wt) = ds.eval_item(0), jds.eval_item(0)
    assert np.array_equal(gt, wt) and sorted(gr) == sorted(wr)


# --- the network, both phases ---


def _bridged(phase, datasets):
    from xrnerf_tpu.models.networks.aninerf import AniNeRFNetwork as JAN

    jds, _ = datasets
    jnet = JAN(**NET_KW, phase=phase)
    params = jnet.init(jax.random.PRNGKey(0), jds.train_batch(0), rng=None, train=False)["params"]
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda a: (0.05 * rng.randn(*a.shape)).astype(np.float32) if a.ndim == 1 else np.asarray(a), params)
    params["tpose_human"]["density_out"]["bias"] = np.full((1,), 2.0, np.float32)
    net = build_network(dict(type="AniNeRFNetwork", **NET_KW, phase=phase), device="cpu")
    net.load_state_dict({k: _t(v) for k, v in state_dict_from_jax(params).items()})
    return jnet, params, net


@pytest.fixture(scope="module", params=["train_pose", "novel_pose"])
def bridged(request, datasets):
    return (request.param, *_bridged(request.param, datasets))


def test_weights_roundtrip(bridged):
    _, _, params, net = bridged
    sd = state_dict_from_jax(params)
    assert set(sd) == set(net.state_dict())
    assert sd["pose_bw_mlp.latent.weight"].shape == (4, 128) and sd["tpose_bw_mlp.latent.weight"].shape == (1, 128)
    back = jax_params_from_state_dict(net.state_dict())
    flat_a, flat_b = jax.tree_util.tree_leaves_with_path(params), jax.tree_util.tree_leaves_with_path(back)
    assert [jax.tree_util.keystr(p) for p, _ in flat_a] == [jax.tree_util.keystr(p) for p, _ in flat_b]
    for (p, a), (_, b) in zip(flat_a, flat_b):
        assert np.array_equal(np.asarray(a), b), jax.tree_util.keystr(p)


def test_network_eval_and_loss_match_jax(bridged, datasets):
    phase, jnet, params, net = bridged
    jds, ds = datasets
    b = jds.train_batch(2)
    want = jax.jit(lambda p, bb: jnet.apply({"params": p}, bb, rng=None, train=False))(params, b)
    tb = {k: _t(v) for k, v in ds.train_batch(2).items()}
    got = net(tb, train=False)
    assert sorted(got) == sorted(want) == ["acc", "depth", "disp", "rgb"]
    assert float(np.asarray(want["acc"]).mean()) > 0.3
    for k in want:
        _close(got[k], want[k], what=k)
    want_loss, want_log = jnet.loss(want, b)
    got_loss, got_log = net.loss({k: _t(np.asarray(v)) for k, v in want.items()}, tb)
    assert sorted(got_log) == sorted(want_log) == ["loss", "mse", "psnr"]
    for k in want_log:
        _close(got_log[k], want_log[k], rtol=1e-5, atol=0, what=k)


def test_network_loss_gradients_match_jax(bridged, datasets):
    """The deterministic training path: ``train_pose``'s image loss plus the
    blend-weight consistency, ``novel_pose``'s consistency alone; per-leaf
    gradients of every field (an unused field's are zero on both sides)."""
    phase, jnet, params, net = bridged
    jds, ds = datasets
    b = {k: jnp.asarray(v) for k, v in jds.train_batch(3).items()}

    def jloss(p):
        return jnet.loss(jnet.apply({"params": p}, b, rng=None, train=True), b)

    (jl, jlog), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    net.zero_grad(set_to_none=True)
    tb = {k: _t(v) for k, v in ds.train_batch(3).items()}
    out = net(tb, generator=None, train=True)
    loss, log = net.loss(out, tb)
    loss.backward()
    assert sorted(log) == sorted(jlog) == ["bw_consistency", "loss", "mse", "psnr"]
    for k in jlog:
        _close(log[k], jlog[k], rtol=1e-5, atol=1e-9, what=k)
    assert float(jlog["bw_consistency"]) > 0
    if phase == "novel_pose":
        assert float(jl) == pytest.approx(float(jlog["bw_consistency"]))
    check_grads(port_grads(net), jg, n_leaves=3 * 11 + 17)


# --- Trainer: trainable_filter ---


@pytest.fixture(scope="module")
def train_pose_ckpt(datasets, tmp_path_factory):
    """A ``train_pose`` run of 4 steps with a checkpoint, and the same run
    resumed from step 2 (bit for bit)."""
    _, ds = datasets
    wd = tmp_path_factory.mktemp("train_pose")

    def trainer(sub, max_iters, **kw):
        return Trainer(build_network(dict(type="AniNeRFNetwork", **NET_KW), device="cpu"), ds,
                       optimizer=dict(type="adam", lr=1e-3), work_dir=str(wd / sub), max_iters=max_iters,
                       ckpt_interval=2, log_interval=2, eval_chunk=200, device="cpu", **kw)

    tr = trainer("a", 4)
    assert tr.run() == 4 and np.isfinite(tr.last_logs["loss"]) and "bw_consistency" in tr.last_logs
    resumed = trainer("b", 4, resume_from=os.path.join(str(wd / "a"), "ckpt_2.pt"))
    assert resumed.start_step == 2 and resumed.run() == 4
    for (k, a), b in zip(tr.network.state_dict().items(), resumed.network.state_dict().values()):
        assert torch.equal(a, b), k
    return ckpt.latest_path(str(wd / "a")), tr.network.state_dict()


def test_novel_pose_trains_only_its_field(datasets, train_pose_ckpt, tmp_path):
    """``novel_pose`` from the ``train_pose`` checkpoint (``load_from``): the
    optimizer, the clip and the EMA hold only ``novel_pose_bw_mlp.*``; after
    the run every other parameter is its loaded value bit for bit, in the
    network and its EMA copy, and every ``novel_pose_bw_mlp`` leaf moved."""
    _, ds = datasets
    path, loaded = train_pose_ckpt
    net = build_network(dict(type="AniNeRFNetwork", **NET_KW, phase="novel_pose"), device="cpu")
    tr = Trainer(net, ds, optimizer=dict(type="adam", lr=1e-3, grad_clip=1.0), work_dir=str(tmp_path),
                 max_iters=3, ckpt_interval=0, log_interval=1, load_from=path, ema_decay=0.5, device="cpu")
    novel = [k for k, _ in net.named_parameters() if k.startswith("novel_pose_bw_mlp.")]
    assert len(novel) == 11 and len(tr.trained_params) == 11
    assert sum(len(g["params"]) for g in tr.optimizer.param_groups) == 11
    assert [k for k, p in net.named_parameters() if p.requires_grad] == novel
    assert tr.run() == 3
    assert tr.last_logs["loss"] == pytest.approx(tr.last_logs["bw_consistency"])
    for name, sd in (("network", net.state_dict()), ("ema", tr.ema_network.state_dict())):
        for k, v in sd.items():
            if k in novel:
                assert not torch.equal(v, loaded[k]), f"{name} {k} did not move"
            else:
                assert torch.equal(v, loaded[k]), f"{name} {k} moved"
    ema, live = tr.ema_network.state_dict(), net.state_dict()
    assert all(not torch.equal(ema[k], live[k]) for k in novel)  # the EMA follows, a step behind


def test_novel_pose_trainer_matches_jax_trainer(datasets, train_pose_ckpt, tmp_path):
    """Three ``novel_pose`` steps of each trainer from the same weights on
    the same batches (deterministic path): the JAX trainer's
    ``optax.set_to_zero`` branch and the port's frozen parameters give the
    same losses and the same trained field."""
    from xrnerf_tpu.core.trainer import Trainer as JTrainer
    from xrnerf_tpu.models.networks.aninerf import AniNeRFNetwork as JAN

    class JDeterministic(JAN):
        def __call__(self, batch, rng=None, train=False):
            return super().__call__(batch, rng=None, train=train)

    class Deterministic(AniNeRFNetwork):
        def forward(self, batch, generator=None, train=False):
            return super().forward(batch, None, train)

    class Losses:
        def __init__(self):
            self.losses = []

        def on_run_begin(self, tr): ...

        def on_eval(self, tr, step): ...

        def on_run_end(self, tr): ...

        def after_step(self, tr, step, logs):
            self.losses.append(float(np.asarray(logs["loss"])))

    jds, ds = datasets
    _, loaded = train_pose_ckpt
    opt = dict(type="adam", lr=1e-3)
    jrec, rec = Losses(), Losses()
    jtr = JTrainer(JDeterministic(**NET_KW, phase="novel_pose"), jds, optimizer=opt,
                   work_dir=str(tmp_path / "jax"), max_iters=3, ckpt_interval=0, log_interval=3, hooks=[jrec])
    p0 = jax_params_from_state_dict({k: v.numpy() for k, v in loaded.items()})
    jtr.state = jtr.state.replace(params=jax.tree_util.tree_map(jnp.asarray, p0))
    tr = Trainer(Deterministic(**NET_KW, phase="novel_pose"), ds, optimizer=opt, work_dir=str(tmp_path / "torch"),
                 max_iters=3, ckpt_interval=0, log_interval=3, hooks=[rec], device="cpu")
    tr.network.load_state_dict(loaded)
    jtr.run()
    tr.run()
    np.testing.assert_allclose(rec.losses, jrec.losses, rtol=1e-4)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtr.state.params))
    for k, p in tr.network.state_dict().items():
        if k.startswith("novel_pose_bw_mlp."):
            np.testing.assert_allclose(p.numpy(), want[k], rtol=0, atol=1e-5, err_msg=k)
        else:
            assert np.array_equal(want[k], loaded[k].numpy()) and torch.equal(p, loaded[k]), k


def test_ema_of_frozen_leaves_matches_jax_trainer(datasets, train_pose_ckpt, tmp_path):
    """``novel_pose`` with ``ema_decay`` 0.95 in both trainers from the same
    weights: the EMA of every frozen leaf equals the JAX trainer's
    ``_ema_update`` bit for bit, including the elements where the plain
    fl(0.95 e) + fl(0.05 e) != e (XLA's fma(0.95, e, fl(0.05 e)) keeps e
    there; an update in the plain form would fail here); the trained
    leaves' EMA agrees at the f32 bar."""
    from xrnerf_tpu.core.trainer import Trainer as JTrainer
    from xrnerf_tpu.models.networks.aninerf import AniNeRFNetwork as JAN

    class JDeterministic(JAN):
        def __call__(self, batch, rng=None, train=False):
            return super().__call__(batch, rng=None, train=train)

    class Deterministic(AniNeRFNetwork):
        def forward(self, batch, generator=None, train=False):
            return super().forward(batch, None, train)

    jds, ds = datasets
    _, loaded = train_pose_ckpt
    opt, d = dict(type="adam", lr=1e-3), 0.95
    jtr = JTrainer(JDeterministic(**NET_KW, phase="novel_pose"), jds, optimizer=opt, work_dir=str(tmp_path / "jax"),
                   max_iters=2, ckpt_interval=0, log_interval=2, ema_decay=d)
    p0 = jax.tree_util.tree_map(jnp.asarray, jax_params_from_state_dict({k: v.numpy() for k, v in loaded.items()}))
    jtr.state = jtr.state.replace(params=p0)
    jtr.ema_params = jax.tree_util.tree_map(jnp.array, p0)
    tr = Trainer(Deterministic(**NET_KW, phase="novel_pose"), ds, optimizer=opt, work_dir=str(tmp_path / "torch"),
                 max_iters=2, ckpt_interval=0, log_interval=2, ema_decay=d, device="cpu")
    tr.network.load_state_dict(loaded)
    tr.ema_network.load_state_dict(loaded)
    jtr.run()
    tr.run()
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtr.ema_params))
    cases = 0
    for k, e in tr.ema_network.state_dict().items():
        if k.startswith("novel_pose_bw_mlp."):
            np.testing.assert_allclose(e.numpy(), want[k], rtol=0, atol=1e-5, err_msg=k)
            continue
        x = loaded[k].numpy()
        cases += int((np.float32(d) * x + np.float32(1 - d) * x != x).sum())  # the smallest case, elementwise
        np.testing.assert_array_equal(e.numpy(), want[k], err_msg=k)
    assert cases > 0


# --- CLI ---


def _ani_cfg(tmp_path, phase, datadir):
    src = open(os.path.join(ROOT, "configs", "aninerf", f"aninerf_zjumocap_{phase}.py")).read()
    cfg = tmp_path / f"ani_{phase}.py"
    cfg.write_text(src + f"""
model.update(n_joints=3, n_samples=8, hidden=16, smpl_dist_threshold=0.2)
data.update(datadir=r"{datadir}", frame_end=2, N_rand=32)
eval_chunk = 200
log_interval = 2
""")
    return cfg


def test_cli_trains_both_phases_and_tests(tmp_path):
    """``train_pose`` then ``novel_pose`` (``--load_from`` its checkpoint)
    through ``run_nerf`` on a ZJU-MoCap layout with the skinning assets on
    disk; ``--test_only`` in a subprocess from the novel-pose weights."""
    arrays = ani_arrays(n_frames=2, n_cams=3, H=16, W=16)
    datadir = write_zju(tmp_path / "zju", arrays, ani=True)
    cfg1, cfg2 = _ani_cfg(tmp_path, "train_pose", datadir), _ani_cfg(tmp_path, "novel_pose", datadir)
    tr1 = run_nerf.main(["--config", str(cfg1), "--device", "cpu", "--max_iters", "2",
                         "--work_dir", str(tmp_path / "tp")])
    assert tr1.step == 2 and tr1.network.phase == "train_pose"
    _close(tr1.dataset.A, build_dataset(dict(type="AniNeRFDataset", arrays=arrays)).A, rtol=0, atol=0)
    tr2 = run_nerf.main(["--config", str(cfg2), "--device", "cpu", "--max_iters", "2", "--work_dir",
                         str(tmp_path / "np"), "--load_from", ckpt.latest_path(str(tmp_path / "tp"))])
    assert tr2.step == 2 and tr2.network.phase == "novel_pose" and len(tr2.trained_params) == 11
    after = tr2.network.state_dict()
    for k, v in tr1.network.state_dict().items():
        assert torch.equal(after[k], v) != k.startswith("novel_pose_bw_mlp."), k
    pt = tmp_path / "w.pt"
    torch.save(after, pt)
    out = subprocess.run(
        [sys.executable, "-m", "xrnerf_torch.run_nerf", "--config", str(cfg2), "--device", "cpu", "--test_only",
         "--load_from", str(pt), "--work_dir", str(tmp_path / "test_only")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert os.path.exists(tmp_path / "test_only" / "test" / "test_results.json")
