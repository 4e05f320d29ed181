"""The NeuralBody slice of the PyTorch port, held against the JAX package on
the same numpy inputs: ``load/synthetic.py:make_synthetic_zju``,
``rays_from_KRT`` and ``aabb_near_far``, ``voxelize_codes``,
``trilinear_sample``, flax's ``padding="SAME"`` at stride 1 and 2, the Conv
kernel's layout in ``utils/weights.py``, ``SmplEmbedder``, ``NBNerfMLP``,
``NeuralBodyNetwork`` (eval outputs, loss, per-leaf loss gradients with
bridged weights), ``NeuralBodyDataset`` (batches, eval and spiral items),
the renderer's ``ctx_*`` keys against the JAX renderer, ``Trainer.run``
with a checkpoint and a bitwise resume, the weights bridge both ways, and
the CLI on ``configs/neuralbody/nb_zjumocap.py`` cut to a small network
over a ZJU-MoCap layout written to disk.

Tolerances. Both sides are f32: forwards rtol 1e-4 / atol 1e-5, discrete
outputs and numpy copies equal; gradients per leaf cosine > 0.999 and norm
ratio within 1e-3 of 1.
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
import jax.numpy as jnp  # noqa: E402

import xrnerf_tpu.models.embedders.neuralbody as jemb  # noqa: E402
import xrnerf_torch.models.embedders.neuralbody as temb  # noqa: E402
from xrnerf_torch import build_dataset, build_network, run_nerf  # noqa: E402
from xrnerf_torch.core.renderer import render_rays_chunked  # noqa: E402
from xrnerf_torch.core.trainer import Trainer  # noqa: E402
from xrnerf_torch.datasets.load.synthetic import make_synthetic_zju  # noqa: E402
from xrnerf_torch.utils import checkpoint as ckpt  # noqa: E402
from xrnerf_torch.utils.weights import jax_params_from_state_dict, state_dict_from_jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
MIN_COS, RATIO_TOL = 0.999, 1e-3
NET_KW = dict(n_verts=200, code_dim=4, grid_dims=(16, 16, 16), conv_widths=(8, 8, 8), num_frames=4,
              appearance_dim=8, hidden=32, n_samples=8)


def _t(a):
    return torch.from_numpy(np.require(np.asarray(a), requirements="C").copy())


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _cos(a, b):
    a, b = np.ravel(np.asarray(a, np.float64)), np.ravel(np.asarray(b, np.float64))
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def check_grads(got_tree, want_tree, n_leaves):
    """Per leaf cosine > 0.999 and norm ratio within 1e-3 of 1; a leaf that
    is zero on the JAX side (an unused field) must be zero here too."""
    want = jax.tree_util.tree_leaves_with_path(want_tree)
    got = jax.tree_util.tree_leaves_with_path(got_tree)
    assert len(want) == len(got) == n_leaves
    for (path, w), (gpath, g) in zip(want, got):
        name = jax.tree_util.keystr(path)
        assert name == jax.tree_util.keystr(gpath)
        w, g = np.asarray(w), np.asarray(g)
        if not np.any(w):
            assert not np.any(g), f"{name}: zero in JAX, max {np.abs(g).max()} here"
            continue
        assert _cos(g, w) > MIN_COS, f"{name}: cos {_cos(g, w)}"
        ratio = float(np.linalg.norm(g) / np.linalg.norm(w))
        assert abs(ratio - 1) < RATIO_TOL, f"{name}: norm ratio {ratio}"


def port_grads(net):
    """The port's parameter gradients as a flax tree (zeros where a frozen or
    unused parameter has none)."""
    return jax_params_from_state_dict(
        {k: (p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32))
         for k, p in net.named_parameters()})


def write_zju(root, arrays, ani=False):
    """Write ``make_synthetic_zju`` arrays (and, with ``ani``, the skinning
    assets) as a ZJU-MoCap directory: ``annots.npy`` (T in mm), one png per
    frame and camera, ``mask_cihp/`` pngs, ``new_vertices/{i}.npy``;
    ``lbs/*.npy`` and ``params/{i}.npy``."""
    import imageio.v2 as imageio

    n_frames, n_cams = arrays["imgs"].shape[:2]
    ims = []
    for f in range(n_frames):
        paths = []
        for c in range(n_cams):
            rel = f"Camera_B{c + 1}/{f:06d}.png"
            for sub, img in (("", arrays["imgs"][f, c]), ("mask_cihp", arrays["masks"][f, c])):
                path = os.path.join(root, sub, rel)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                imageio.imwrite(path, np.round(255 * np.clip(img, 0, 1)).astype(np.uint8))
            paths.append(rel)
        ims.append({"ims": paths})
        os.makedirs(os.path.join(root, "new_vertices"), exist_ok=True)
        np.save(os.path.join(root, "new_vertices", f"{f}.npy"), arrays["verts"][f])
    cams = {"K": arrays["K"], "R": arrays["R"], "T": arrays["T"][..., None] * 1000.0,
            "D": np.zeros((n_cams, 5, 1), np.float32)}
    np.save(os.path.join(root, "annots.npy"), np.array({"cams": cams, "ims": ims}, dtype=object))
    if ani:
        os.makedirs(os.path.join(root, "lbs"), exist_ok=True)
        os.makedirs(os.path.join(root, "params"), exist_ok=True)
        for name in ("joints", "parents", "weights"):
            np.save(os.path.join(root, "lbs", f"{name}.npy"), arrays[name])
        for f in range(n_frames):
            np.save(os.path.join(root, "params", f"{f}.npy"),
                    np.array({"poses": arrays["poses"][f].reshape(1, -1)}, dtype=object))
    return str(root)


@pytest.fixture(scope="module")
def zju():
    return make_synthetic_zju(n_frames=2, n_cams=4, H=24, W=24, n_verts=200)


# --- load/synthetic.py, rays ---


@pytest.mark.parametrize("kw", [dict(), dict(n_frames=3, n_cams=5, H=20, W=28, n_verts=64, seed=7)],
                         ids=["default", "seed7"])
def test_make_synthetic_zju_matches_jax(kw):
    from xrnerf_tpu.datasets.load.synthetic import make_synthetic_zju as jmake

    want, got = jmake(**kw), make_synthetic_zju(**kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_rays_and_near_far_match_jax(zju):
    from xrnerf_tpu.datasets.neuralbody import aabb_near_far as jnf, rays_from_KRT as jrays
    from xrnerf_torch.datasets.neuralbody import aabb_near_far, rays_from_KRT

    rng = np.random.RandomState(0)
    pix = np.stack([rng.randint(0, 24, 50), rng.randint(0, 24, 50)], -1)
    for c in range(4):
        args = (24, 24, zju["K"][c], zju["R"][c], zju["T"][c])
        for p in (None, pix):
            o, d = rays_from_KRT(*args, pix=p)
            jo, jd = jrays(*args, pix=p)
            assert np.array_equal(o, jo) and np.array_equal(d, jd)
            bmin, bmax = zju["verts"][0].min(0) - 0.1, zju["verts"][0].max(0) + 0.1
            for got, want in zip(aabb_near_far(o, d, bmin, bmax), jnf(jo, jd, bmin, bmax)):
                assert np.array_equal(got, want)
    # a miss gets near == far; an axis-parallel ray divides by the 1e-10 floor
    o = np.array([[0.0, 0.0, -5.0], [10.0, 10.0, 10.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32)
    for got, want in zip(aabb_near_far(o, d, -np.ones(3), np.ones(3), pad=0.0),
                         jnf(o, d, -np.ones(3), np.ones(3), pad=0.0)):
        assert np.array_equal(got, want)


# --- models/embedders/neuralbody.py ---


@pytest.mark.parametrize("dims", [(8, 8, 8), (5, 7, 6)])
def test_voxelize_codes_matches_jax(dims):
    rng = np.random.RandomState(1)
    verts = rng.uniform(-0.5, 0.7, (300, 3)).astype(np.float32)
    verts[100:150] = verts[:50]  # duplicates share a voxel
    verts[0] = [-0.5, -0.5, -0.5]  # both corners of the box
    verts[1] = [0.7, 0.7, 0.7]
    codes = rng.randn(300, 6).astype(np.float32)
    bmin, bmax = np.full(3, -0.5, np.float32), np.full(3, 0.7, np.float32)
    want = jemb.voxelize_codes(jnp.asarray(verts), jnp.asarray(codes), jnp.asarray(bmin), jnp.asarray(bmax), dims)
    got = temb.voxelize_codes(_t(verts), _t(codes), _t(bmin), _t(bmax), dims)
    assert tuple(got.shape) == (*dims, 6)
    _close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dims", [(2, 2, 2), (4, 5, 6)])
def test_trilinear_sample_matches_jax(dims):
    rng = np.random.RandomState(2)
    vol = rng.randn(*dims, 5).astype(np.float32)
    rel = rng.uniform(-0.1, 1.1, (400, 3)).astype(np.float32)  # outside [0, 1] too: the clamping
    rel[:8] = np.array([[i >> 2 & 1, i >> 1 & 1, i & 1] for i in range(8)], np.float32)  # the corners
    rel[8] = 0.5
    want = jemb.trilinear_sample(jnp.asarray(vol), jnp.asarray(rel))
    got = temb.trilinear_sample(_t(vol), _t(rel))
    _close(got, want, rtol=1e-6, atol=1e-6)
    corners = vol[[(dims[0] - 1) * (i >> 2 & 1) for i in range(8)], [(dims[1] - 1) * (i >> 1 & 1) for i in range(8)],
                  [(dims[2] - 1) * (i & 1) for i in range(8)]]
    np.testing.assert_array_equal(_np(got)[:8], corners)  # a corner is the voxel itself


def _flax_conv(x, stride, seed, cin=3, cout=4):
    """A flax ``nn.Conv`` (3x3x3, SAME) with seeded weights over x [D, H, W,
    cin]: (output [D', H', W', cout], its params)."""
    import flax.linen as nn

    conv = nn.Conv(cout, (3, 3, 3), strides=(stride,) * 3, padding="SAME")
    rng = np.random.RandomState(seed)
    params = {"kernel": rng.randn(3, 3, 3, cin, cout).astype(np.float32),
              "bias": rng.randn(cout).astype(np.float32)}
    return np.asarray(conv.apply({"params": params}, jnp.asarray(x[None])))[0], params


def _port_conv(params, stride):
    conv = torch.nn.Conv3d(params["kernel"].shape[3], params["kernel"].shape[4], 3, stride=stride)
    conv.load_state_dict({k[len("c."):]: _t(v) for k, v in state_dict_from_jax({"c": params}).items()})
    return conv


@pytest.mark.parametrize("size", [8, 9, 6])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_same_padding_matches_flax(size, stride):
    """flax ``padding="SAME"`` pads (0, 1) at stride 2 on an even size (XLA's
    rule) and (1, 1) otherwise; ``conv3d_same`` gives flax's output. On the
    even stride-2 sizes ``Conv3d(padding=1)`` is off by one voxel."""
    x = np.random.RandomState(size).randn(size, size - 1 if size > 6 else size, size, 3).astype(np.float32)
    want, params = _flax_conv(x, stride, seed=stride)
    conv = _port_conv(params, stride)
    xt = _t(x).permute(3, 0, 1, 2)[None]
    got = temb.conv3d_same(conv, xt)[0].permute(1, 2, 3, 0)
    assert tuple(got.shape) == want.shape
    _close(got, want, rtol=1e-5, atol=1e-5)
    naive = torch.nn.functional.conv3d(xt, conv.weight, conv.bias, stride, 1)[0].permute(1, 2, 3, 0)
    if stride == 2 and any(n % 2 == 0 for n in x.shape[:3]):
        assert float(np.abs(_np(naive) - want).max()) > 0.1  # symmetric padding=1 is wrong here
    else:
        _close(naive, want, rtol=1e-5, atol=1e-5)


def test_conv_kernel_layout_in_weights_bridge():
    """A flax kernel [kd, kh, kw, in, out] becomes weight [out, in, kd, kh,
    kw] by ``transpose(4, 3, 0, 1, 2)``; a plain ``.T`` (all five axes
    reversed) swaps kd and kw and gives another output."""
    x = np.random.RandomState(5).randn(8, 8, 8, 3).astype(np.float32)
    want, params = _flax_conv(x, 1, seed=6)
    conv = _port_conv(params, 1)
    xt = _t(x).permute(3, 0, 1, 2)[None]
    _close(temb.conv3d_same(conv, xt)[0].permute(1, 2, 3, 0), want, rtol=1e-5, atol=1e-5)
    assert tuple(conv.weight.shape) == (4, 3, 3, 3, 3)
    transposed = torch.nn.functional.conv3d(xt, _t(params["kernel"].T), conv.bias, 1, 1)[0].permute(1, 2, 3, 0)
    assert float(np.abs(_np(transposed) - want).max()) > 0.1
    back = jax_params_from_state_dict({k: v.detach() for k, v in conv.state_dict().items()})
    assert np.array_equal(back["kernel"], params["kernel"]) and np.array_equal(back["bias"], params["bias"])


@pytest.mark.parametrize("grid,widths", [((8, 8, 8), (4, 4, 4)), ((9, 8, 7), (4, 3))], ids=["8cube", "odd"])
def test_smpl_embedder_matches_jax(grid, widths):
    """Voxelised codes, the conv stack (stride 2 from level 1: 8 -> 4 -> 2;
    9 x 8 x 7 -> 5 x 4 x 4) and the per-level samples."""
    rng = np.random.RandomState(3)
    verts = rng.uniform(0.2, 0.8, (50, 3)).astype(np.float32)
    pts = rng.uniform(-0.1, 1.1, (97, 3)).astype(np.float32)
    bmin, bmax = np.zeros(3, np.float32), np.ones(3, np.float32)
    emb = jemb.SmplEmbedder(n_verts=50, code_dim=4, grid_dims=grid, widths=widths)
    ids = jnp.arange(50)
    params = emb.init(jax.random.PRNGKey(0), ids, verts, pts, bmin, bmax)["params"]
    params = jax.tree_util.tree_map(lambda a: (0.1 * rng.randn(*a.shape)).astype(np.float32) if a.ndim == 1
                                    else np.asarray(a), params)
    want = jax.jit(lambda p: emb.apply({"params": p}, ids, verts, pts, bmin, bmax))(params)
    net = temb.SmplEmbedder(n_verts=50, code_dim=4, grid_dims=grid, widths=widths)
    net.load_state_dict({k: _t(v) for k, v in state_dict_from_jax(params).items()})
    got = net(_t(verts), _t(pts), _t(bmin), _t(bmax))
    assert tuple(got.shape) == (97, sum(widths))
    _close(got, want)


def test_embedder_init_follows_flax():
    """Embed: normal, std 1/sqrt(features); Conv: truncated lecun-normal over
    27 * in, zero bias."""
    net = temb.SmplEmbedder(n_verts=6890, code_dim=16, grid_dims=(8, 8, 8), widths=(32,))
    net.reset_parameters(torch.Generator().manual_seed(0))
    codes = net.vertex_codes.weight.detach()
    assert abs(float(codes.std()) - 0.25) < 0.005 and abs(float(codes.mean())) < 0.005
    w = net.conv_0b.weight.detach()
    assert abs(float(w.std()) - (1 / (27 * 32)) ** 0.5) < 0.002
    assert float(w.abs().max()) <= 2 * (1 / (27 * 32)) ** 0.5 / 0.87962566103423978 + 1e-6
    assert not net.conv_0b.bias.detach().any()


# --- fields / network ---


def test_nb_mlp_matches_jax():
    from xrnerf_tpu.models.fields.nb_mlp import NBNerfMLP as JMLP
    from xrnerf_torch.models.fields.nb_mlp import NBNerfMLP

    rng = np.random.RandomState(4)
    feat, dirs = rng.randn(33, 12).astype(np.float32), rng.randn(33, 3).astype(np.float32)
    pts = rng.uniform(-1, 1, (33, 3)).astype(np.float32)
    fidx = np.asarray(2, np.int32)
    mlp = JMLP(num_frames=4, appearance_dim=8, hidden=32)
    params = mlp.init(jax.random.PRNGKey(0), feat, dirs, pts, fidx)["params"]
    want = mlp.apply({"params": params}, feat, dirs, pts, fidx)
    net = NBNerfMLP(in_ch=12, num_frames=4, appearance_dim=8, hidden=32)
    net.load_state_dict({k: _t(v) for k, v in state_dict_from_jax(params).items()})
    got = net(_t(feat), _t(dirs), _t(pts), _t(fidx))
    for g, w in zip(got, want):
        _close(g, w)


def _jax_net():
    from xrnerf_tpu.models.networks.neuralbody import NeuralBodyNetwork as JNB

    return JNB(**NET_KW)


@pytest.fixture(scope="module")
def datasets(zju):
    from xrnerf_tpu.datasets.neuralbody import NeuralBodyDataset as JDS

    kw = dict(N_rand=32, training_view=(0, 1, 2))
    return JDS(arrays=zju, **kw), build_dataset(dict(type="NeuralBodyDataset", arrays=zju, **kw))


@pytest.fixture(scope="module")
def bridged(datasets):
    """(flax module, its params with small random biases and a density bias
    of 2 so the box renders, the port's network with the same weights)."""
    jds, _ = datasets
    jnet = _jax_net()
    params = jnet.init(jax.random.PRNGKey(0), jds.train_batch(0), rng=None, train=False)["params"]
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda a: (0.05 * rng.randn(*a.shape)).astype(np.float32) if a.ndim == 1 else np.asarray(a), params)
    params["mlp"]["alpha"]["bias"] = np.full((1,), 2.0, np.float32)
    net = build_network(dict(type="NeuralBodyNetwork", **NET_KW), device="cpu")
    net.load_state_dict({k: _t(v) for k, v in state_dict_from_jax(params).items()})
    return jnet, params, net


def test_weights_roundtrip(bridged):
    _, params, net = bridged
    sd = state_dict_from_jax(params)
    assert set(sd) == set(net.state_dict())
    assert sd["embedder.vertex_codes.weight"].shape == (200, 4)
    assert sd["embedder.conv_1b.weight"].shape == (8, 8, 3, 3, 3)
    back = jax_params_from_state_dict(net.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [jax.tree_util.keystr(p) for p, _ in flat_a] == [jax.tree_util.keystr(p) for p, _ in flat_b]
    for (p, a), (_, b) in zip(flat_a, flat_b):
        assert np.array_equal(np.asarray(a), b), jax.tree_util.keystr(p)


def test_network_eval_and_loss_match_jax(bridged, datasets):
    jnet, params, net = bridged
    jds, ds = datasets
    b = jds.train_batch(5)
    want = jax.jit(lambda p, bb: jnet.apply({"params": p}, bb, rng=None, train=False))(params, b)
    tb = {k: _t(v) for k, v in ds.train_batch(5).items()}
    got = net(tb, train=False)
    assert sorted(got) == sorted(want) == ["acc", "depth", "disp", "rgb"]
    assert not got["rgb"].requires_grad
    assert float(np.asarray(want["acc"]).mean()) > 0.3  # the box renders
    for k in want:
        _close(got[k], want[k], what=k)
    want_loss, want_log = jnet.loss(want, b)
    got_loss, got_log = net.loss({k: _t(np.asarray(v)) for k, v in want.items()}, tb)
    assert sorted(got_log) == sorted(want_log) == ["acc_err", "loss", "mse", "psnr"]
    for k in want_log:
        _close(got_log[k], want_log[k], rtol=1e-5, atol=0, what=k)


def test_network_loss_gradients_match_jax(bridged, datasets):
    """The deterministic training path (no generator / ``rng=None``): the
    loss and its gradients per leaf, vertex codes through the scatter-mean,
    the convs and the trilinear gathers included."""
    jnet, params, net = bridged
    jds, ds = datasets
    b = jds.train_batch(6)

    def jloss(p):
        return jnet.loss(jnet.apply({"params": p}, b, rng=None, train=True), b)[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    net.zero_grad(set_to_none=True)
    tb = {k: _t(v) for k, v in ds.train_batch(6).items()}
    out = net(tb, generator=None, train=True)
    loss, _ = net.loss(out, tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    assert float(np.abs(jg["embedder"]["vertex_codes"]["embedding"]).max()) > 0
    check_grads(port_grads(net), jg, n_leaves=26)


def test_train_mode_draws_from_generator(bridged, datasets):
    _, _, net = bridged
    tb = {k: _t(v) for k, v in datasets[1].train_batch(7).items()}
    a = net(tb, generator=torch.Generator().manual_seed(0), train=True)["rgb"]
    b = net(tb, generator=torch.Generator().manual_seed(0), train=True)["rgb"]
    c = net(tb, generator=torch.Generator().manual_seed(1), train=True)["rgb"]
    assert torch.equal(a, b) and not torch.equal(a, c)


# --- datasets/neuralbody.py ---


def test_dataset_matches_jax(datasets):
    jds, ds = datasets
    assert ds.train_pairs == jds.train_pairs and ds.test_pairs == jds.test_pairs
    np.testing.assert_array_equal(ds.i_val, jds.i_val)
    np.testing.assert_array_equal(ds.i_test, jds.i_test)
    for step, host, hosts in ((0, 0, 1), (1, 0, 1), (9, 0, 1), (3, 1, 2)):
        want, got = jds.train_batch(step, host, hosts), ds.train_batch(step, host, hosts)
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.shape(got[k]) == np.shape(want[k]) and np.array_equal(got[k], want[k]), (step, k)
    for i in ds.i_test:
        (gr, gt), (wr, wt) = ds.eval_item(int(i)), jds.eval_item(int(i))
        assert np.array_equal(gt, wt) and all(np.array_equal(gr[k], wr[k]) for k in wr)
    np.testing.assert_array_equal(ds.render_poses, jds.render_poses)
    pose = ds.render_poses[3]
    (gr, ghw), (wr, whw) = ds.spiral_item(pose), jds.spiral_item(pose)
    assert ghw == whw and all(np.array_equal(gr[k], wr[k]) for k in wr)


# --- core/renderer.py: ctx keys ---


def test_renderer_passes_ctx_whole_to_every_chunk():
    """``ctx_*`` keys and 0-d arrays reach every chunk as they are (not
    padded, not sliced); ray keys are chunked and padded."""
    seen = []

    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(1))

        def forward(self, batch, train=False):
            seen.append({k: tuple(v.shape) for k, v in batch.items()})
            return {"rgb": batch["rays_o"] + batch["ctx_shift"] + batch["scale"]}

    rays = {"rays_o": np.arange(30, dtype=np.float32).reshape(10, 3), "ctx_shift": np.ones(3, np.float32),
            "ctx_verts": np.zeros((7, 3), np.float32), "scale": np.asarray(2.0, np.float32),
            "target": np.zeros((10, 3), np.float32)}
    out = render_rays_chunked(Probe(), rays, chunk=4, keys=("rgb",))
    assert seen == [{"rays_o": (4, 3), "ctx_shift": (3,), "ctx_verts": (7, 3), "scale": ()}] * 3
    np.testing.assert_array_equal(out["rgb"], rays["rays_o"] + 3.0)


def test_render_image_matches_jax(bridged, datasets):
    """``Trainer.render_image`` of held-out views (576 rays in chunks of 100,
    the last padded) against the JAX renderer, both handing the context to
    every chunk."""
    from xrnerf_tpu.core.renderer import render_image as jrender_image

    jnet, params, net = bridged
    jds, ds = datasets
    tr = Trainer(net, ds, work_dir=None, eval_chunk=100, device="cpu")
    tr.network.load_state_dict({k: _t(v) for k, v in state_dict_from_jax(params).items()})

    def apply_fn(p, bb, rng):
        return jnet.apply({"params": p}, bb, rng=None, train=False)

    for item in ds.i_test:  # (frame, camera 3) for both frames
        rays, gt = ds.eval_item(int(item))
        got = tr.render_image(rays, 24, 24)
        want = jrender_image(apply_fn, params, jds.eval_item(int(item))[0], 24, 24, chunk=100)
        assert got["rgb"].shape == gt.shape
        for k in ("rgb", "acc", "disp"):
            _close(got[k], want[k], what=k)
        assert float(want["acc"].max()) > 0.5


# --- Trainer and CLI ---


def test_trainer_checkpoint_and_bitwise_resume(datasets, tmp_path):
    """6 steps straight against 4 steps, a checkpoint, and a resume to 6:
    the same parameters bit for bit; the loss falls."""
    _, ds = datasets

    def trainer(wd, max_iters, **kw):
        return Trainer(build_network(dict(type="NeuralBodyNetwork", **NET_KW), device="cpu"), ds,
                       optimizer=dict(type="adam", lr=5e-3), work_dir=str(wd), max_iters=max_iters,
                       ckpt_interval=4, log_interval=2, eval_chunk=256, device="cpu", **kw)

    straight = trainer(tmp_path / "a", 6)
    assert straight.run() == 6 and np.isfinite(straight.last_logs["loss"])
    half = trainer(tmp_path / "b", 4)
    half.run()
    resumed = trainer(tmp_path / "c", 6, resume_from=ckpt.latest_path(str(tmp_path / "b")))
    assert resumed.start_step == 4 and resumed.run() == 6
    for (k, a), b in zip(straight.network.state_dict().items(), resumed.network.state_dict().values()):
        assert torch.equal(a, b), k


def _nb_cfg(tmp_path, datadir):
    """``configs/neuralbody/nb_zjumocap.py`` as written, the network narrowed
    and the data pointed at ``datadir``."""
    src = open(os.path.join(ROOT, "configs", "neuralbody", "nb_zjumocap.py")).read()
    cfg = tmp_path / "nb_cfg.py"
    cfg.write_text(src + f"""
model.update(n_verts=200, code_dim=4, grid_dims=(8, 8, 8), conv_widths=(4, 4), appearance_dim=8, hidden=16,
             n_samples=8)
data.update(datadir=r"{datadir}", frame_end=2, N_rand=64)
eval_chunk = 256
log_interval = 2
""")
    return cfg


def test_cli_trains_and_tests_neuralbody(tmp_path):
    """``run_nerf`` trains the narrowed config on a ZJU-MoCap layout on disk
    (the dataset read from it equals the in-memory one), then ``python -m
    xrnerf_torch.run_nerf --test_only --load_from`` gives the test set's PSNR
    the weights give in this process."""
    from xrnerf_torch.core.hooks import TestHook

    arrays = make_synthetic_zju(n_frames=2, n_cams=3, H=16, W=16, n_verts=200)
    datadir = write_zju(tmp_path / "zju", arrays)
    cfg = _nb_cfg(tmp_path, datadir)
    tr = run_nerf.main(["--config", str(cfg), "--device", "cpu", "--max_iters", "2",
                        "--work_dir", str(tmp_path / "wd")])
    assert tr.step == 2 and np.isfinite(tr.last_logs["loss"])
    ds = tr.dataset
    assert ds.imgs.shape == (2, 3, 16, 16, 3) and ds.train_pairs == [(0, 0), (1, 0)]
    np.testing.assert_allclose(ds.imgs, arrays["imgs"] * arrays["masks"][..., None], atol=0.5 / 255 + 1e-6)
    np.testing.assert_array_equal(ds.masks, arrays["masks"])
    np.testing.assert_allclose(ds.Ts, arrays["T"], rtol=1e-6, atol=1e-7)
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


def test_cli_sets_card_math_before_building(monkeypatch):
    """On the card the CLI calls ``configure_card`` before it builds anything,
    and on the CPU it does not; ``configure_card`` turns TF32 off for matmul
    and cuDNN (the JAX conv stack is f32) and cuDNN's algorithm search on."""
    from types import SimpleNamespace

    from xrnerf_torch.utils import device as device_mod

    configure_card = device_mod.configure_card
    calls = []
    monkeypatch.setattr(device_mod, "configure_card", lambda: calls.append("configure_card"))
    monkeypatch.setattr(run_nerf, "build_from_config",
                        lambda cfg, args: calls.append(args.device) or SimpleNamespace(run=lambda: None))
    cfg = os.path.join(ROOT, "configs", "neuralbody", "nb_zjumocap.py")
    for device in ("cpu", "cuda"):
        run_nerf.main(["--config", cfg, "--device", device, "--max_iters", "1"])
    assert calls == ["cpu", "configure_card", "cuda"]

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        torch.backends.cudnn.benchmark = False
        configure_card()
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                torch.backends.cudnn.benchmark) == (False, False, True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = flags
