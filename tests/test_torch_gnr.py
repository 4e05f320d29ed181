"""The GNR slice of the PyTorch port, held against the JAX package on the
same numpy inputs: ``gnr_embedder`` (posenc, SH, flax's GroupNorm, the
cubic resize against ``jax.image.resize``, 2-D conv kernels through
``utils/weights.py`` both ways, ``HGFilter``, ``SRFilters``), ``gnr_mlp``,
``gnr_render`` (grid sampling, projections, ray segments, the fused
``sample_segment``, visual hull, SMPL visibility, compositing),
``GnrNetwork`` (outputs, loss, per-leaf loss gradients with bridged weights,
the hull-first compaction, density / colour queries and the reconstruction
through them), ``GeneBodyDataset`` (batches, eval and spiral items, the
on-disk layout), the renderer's chunks against the JAX renderer,
``Trainer`` with a bitwise resume, and the CLI on
``configs/gnr/gnr_genebody.py`` cut to a small network. Mirrors
``tests/test_gnr.py`` at its sizes (``load_size`` 32, one stack, hourglass
dim 8, MLP width 16, ``mesh_chunk`` 128).

Tolerances. f32 both sides: functions rtol 1e-4 / atol 1e-5, numpy copies
and discrete outputs equal; gradients per leaf cosine > 0.999 and norm
ratio within 1e-3 of 1. A sample inside the visual hull whose nearest SMPL
face is a near-tie (the port's face index differs from JAX's: the two
round the faces' distances differently, ``tests/test_torch_mesh.py``) or
whose winding number is within 1e-5 of 0.5 takes its T-pose feature (or
its sign) from another face; a ray that holds one is held to ``TIE_ATOL``
instead, and the test prints how many there were.
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

import xrnerf_tpu.models.embedders.gnr_embedder as jemb  # noqa: E402
import xrnerf_tpu.models.renders.gnr_render as jrender  # noqa: E402
import xrnerf_torch.models.embedders.gnr_embedder as temb  # noqa: E402
import xrnerf_torch.models.renders.gnr_render as trender  # noqa: E402
from test_torch_neuralbody import check_grads, port_grads  # noqa: E402
from xrnerf_torch import build_dataset, build_network, run_nerf  # noqa: E402
from xrnerf_torch.core.trainer import Trainer  # noqa: E402
from xrnerf_torch.datasets.load.synthetic import make_synthetic_genebody  # noqa: E402
from xrnerf_torch.utils.weights import jax_params_from_state_dict, state_dict_from_jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
TIE_ATOL = 0.1  # a ray with a near-tie sample in the hull (see the module docstring)
NET_KW = dict(num_views=4, n_samples=8, load_size=32, num_stack=1, num_hourglass=1, hourglass_dim=8, mlp_depth=3,
              mlp_width=16, skips=(1,), mesh_chunk=128)
DS_KW = dict(num_views=4, input_views=(0, 1, 2, 3))


def _t(a):
    return torch.from_numpy(np.require(np.asarray(a), requirements="C").copy())


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


def _bridge_flax(module, params):
    """Load a flax param tree into a port module through ``utils/weights.py``."""
    module.load_state_dict({k: _t(v) for k, v in state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)).items()})
    return module


# --- embedders ---


def test_posenc_and_spherical_harmonics_match_jax():
    freqs = temb.gnr_posenc_freqs(10, 0.1 / 256, 10 / 256)
    np.testing.assert_array_equal(freqs, jemb.gnr_posenc_freqs(10, 0.1 / 256, 10 / 256))
    np.testing.assert_array_equal(temb.gnr_posenc_freqs(6), jemb.gnr_posenc_freqs(6))
    rng = np.random.RandomState(0)
    x = rng.randn(7, 5, 3).astype(np.float32)
    for f in (freqs, temb.gnr_posenc_freqs(4, 0.1, 10.0)):
        _close(temb.gnr_posenc(_t(x), _t(f)), jemb.gnr_posenc(jnp.asarray(x), f))
    assert temb.gnr_posenc_dim(3, 4) == jemb.gnr_posenc_dim(3, 4) == 27
    d = rng.randn(16, 5, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    sh = temb.spherical_harmonics(_t(d), rank=3)
    _close(sh, jemb.spherical_harmonics(jnp.asarray(d), rank=3))
    _close(sh[..., 0], np.full(d.shape[:-1], 1.0 / (2 * np.sqrt(np.pi))))
    assert temb.sh_dim() == jemb.sh_dim() == 9


@pytest.mark.parametrize("src,dst", [((8, 8), (16, 16)), ((5, 7), (10, 14)), ((16, 12), (8, 6)), ((32, 32), (8, 8)),
                                     ((7, 9), (3, 4))])
def test_cubic_resize_matches_jax_image_resize(src, dst):
    """Up 2x (even and odd sizes) and down (antialiased, 2x and 4x, odd),
    edges included, against ``jax.image.resize(..., "cubic")``; torch's
    ``bicubic`` is not this function."""
    x = np.random.RandomState(sum(src)).randn(2, 4, *src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x.transpose(0, 2, 3, 1)), (2, *dst, 4), "cubic")).transpose(0, 3, 1, 2)
    _close(temb.cubic_resize(_t(x), dst), want)
    if dst == (16, 16):
        bicubic = torch.nn.functional.interpolate(_t(x), size=dst, mode="bicubic", align_corners=False)
        assert float(np.abs(bicubic.numpy() - want).max()) > 1e-2


def test_group_norm_matches_flax():
    import flax.linen as nn

    rng = np.random.RandomState(1)
    x = (3.0 + 2.0 * rng.randn(2, 5, 6, 64)).astype(np.float32)  # a large mean: fast variance's case
    gn = nn.GroupNorm(num_groups=32)
    params = gn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {"params": {"scale": jnp.asarray(rng.randn(64).astype(np.float32)),
                         "bias": jnp.asarray(rng.randn(64).astype(np.float32))}}
    want = np.asarray(gn.apply(params, jnp.asarray(x)))
    mod = temb.GroupNorm(64)
    mod.load_state_dict({k: _t(v) for k, v in state_dict_from_jax(params["params"]).items()})
    _close(mod(_t(x.transpose(0, 3, 1, 2))).permute(0, 2, 3, 1), want)
    assert sorted(mod.state_dict()) == ["bias", "scale"]


def test_conv2d_kernels_cross_both_ways():
    """A flax 3x5 conv (bias and no bias) and its ``Conv2d`` through
    ``utils/weights.py`` compute the same convolution; the way back gives
    the flax kernel bit for bit."""
    import flax.linen as nn

    rng = np.random.RandomState(2)
    x = rng.randn(2, 9, 11, 3).astype(np.float32)
    for bias in (True, False):
        conv = nn.Conv(4, (3, 5), use_bias=bias, padding="SAME")
        params = conv.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
        want = np.asarray(conv.apply({"params": params}, jnp.asarray(x)))
        sd = state_dict_from_jax({"c": params})
        assert sd["c.weight"].shape == (4, 3, 3, 5) and ("c.bias" in sd) == bias
        tconv = torch.nn.Conv2d(3, 4, (3, 5), padding=(1, 2), bias=bias)
        tconv.load_state_dict({k[2:]: _t(v) for k, v in sd.items()})
        _close(tconv(_t(x.transpose(0, 3, 1, 2))).permute(0, 2, 3, 1), want)
        back = jax_params_from_state_dict(sd)["c"]
        np.testing.assert_array_equal(back["kernel"], np.asarray(params["kernel"]))
        assert sorted(back) == sorted(params)


@pytest.mark.parametrize("hg_down", ["ave_pool", "conv128"])
def test_hgfilter_matches_jax(hg_down):
    rng = np.random.RandomState(3)
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    jnet = jemb.HGFilter(num_stack=2, num_hourglass=2, hourglass_dim=8, hg_down=hg_down)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(lambda p: p + 0.1 * jnp.asarray(rng.randn(*p.shape).astype(np.float32)), params)
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)))
    net = _bridge_flax(temb.HGFilter(num_stack=2, num_hourglass=2, hourglass_dim=8, hg_down=hg_down), params)
    with torch.no_grad():
        got = net(_t(x.transpose(0, 3, 1, 2))).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 8, 8, 8)
    _close(got, want, atol=1e-4 * float(np.abs(want).max()))


def test_srfilters_matches_jax():
    rng = np.random.RandomState(4)
    feat, imgs = rng.randn(2, 8, 8, 16).astype(np.float32), rng.rand(2, 32, 32, 3).astype(np.float32)
    jnet = jemb.SRFilters(order=2, out_ch=8)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(feat), jnp.asarray(imgs))["params"]
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(feat), jnp.asarray(imgs)))
    net = _bridge_flax(temb.SRFilters(order=2, out_ch=8, in_ch=16), params)
    got = net(_t(feat.transpose(0, 3, 1, 2)), _t(imgs.transpose(0, 3, 1, 2))).permute(0, 2, 3, 1)
    assert got.shape == (2, 32, 32, 8)
    _close(got, want)


# --- render building blocks ---


def test_grid_sample_and_index_views_match_jax():
    rng = np.random.RandomState(5)
    feats = rng.randn(3, 6, 5, 4).astype(np.float32)  # [V, H, W, C]
    uv = rng.uniform(-1.3, 1.3, (3, 50, 2)).astype(np.float32)
    uv[:, :4] = [[0.0, 0.0], [-0.8, 0.6], [0.2, -1.0 + 1.0 / 6], [1.0, 1.0]]  # texel centres, halves, the edge
    for mode in ("bilinear", "nearest"):
        want = np.asarray(jrender.index_views(jnp.asarray(feats), jnp.asarray(uv), mode))
        _close(trender.index_views(_t(feats.transpose(0, 3, 1, 2)), _t(uv), mode), want, what=mode)
    one = trender.grid_sample_2d(_t(np.arange(16.0, dtype=np.float32).reshape(1, 4, 4)), _t(np.zeros((1, 2), np.float32)))
    assert float(one[0, 0]) == pytest.approx(7.5)


def test_projections_and_rays_match_jax():
    rng = np.random.RandomState(6)
    pts = rng.randn(40, 3).astype(np.float32)
    arr = make_synthetic_genebody(n_frames=1, n_cams=3, H=32, W=32)
    w2c = arr["w2c"]
    K = arr["K"][0]
    cam6 = np.stack([[K[0, 0], K[1, 1], K[0, 2], K[1, 2], 0.5, 5.0]] * 3).astype(np.float32)
    cam11 = np.concatenate([cam6[:, :4], 0.01 * rng.randn(3, 5), cam6[:, 4:]], 1).astype(np.float32)
    for cam in (cam6, cam11):
        _close(trender.perspective_project(_t(pts), _t(w2c), _t(cam)),
               jrender.perspective_project(jnp.asarray(pts), jnp.asarray(w2c), jnp.asarray(cam)), rtol=1e-4, atol=1e-4)
    _close(trender.orthogonal_project(_t(pts), _t(w2c)), jrender.orthogonal_project(jnp.asarray(pts), jnp.asarray(w2c)))
    pix = rng.uniform(0, 32, (20, 2)).astype(np.float32)
    for cam in (cam6[0], cam11[0]):
        for a, b in zip(trender.rays_perspective_np(pix, w2c[0], cam), jrender.rays_perspective_np(pix, w2c[0], cam)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(trender.rays_orthogonal_np(pix, w2c[0], 32, 32), jrender.rays_orthogonal_np(pix, w2c[0], 32, 32)):
        np.testing.assert_array_equal(a, b)


def test_sample_segment_is_jaxs_fused_form():
    """``rays_e * t + rays_s * (1 - t)`` under ``jax.jit`` (XLA contracts it
    to an FMA) and the port's ``addcmul``: the same bits, without and with
    the same jitter draws."""
    rng = np.random.RandomState(7)
    s, e = (rng.randn(33, 3).astype(np.float32) for _ in range(2))
    u = rng.rand(33, 16).astype(np.float32)
    jp, jt = jax.jit(lambda a, b: jrender.sample_segment(a, b, 16))(jnp.asarray(s), jnp.asarray(e))
    tp, tt = trender.sample_segment(_t(s), _t(e), 16)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))

    @jax.jit
    def jitter(a, b, uu):  # sample_segment's body with the uniform draws given
        t = jnp.broadcast_to(jnp.linspace(0.0, 1.0, 16), (33, 16)) + (uu - 0.5) / 15
        return b[:, None] * t[..., None] + a[:, None] * (1 - t[..., None]), t

    jp, jt = jitter(jnp.asarray(s), jnp.asarray(e), jnp.asarray(u))
    tp, tt = trender.sample_segment(_t(s), _t(e), 16, jitter=_t(u))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_visual_hull_and_smpl_visibility_match_jax():
    arr = make_synthetic_genebody(n_frames=1, n_cams=4, H=32, W=32)
    K = arr["K"][0]
    persps = np.stack([[K[0, 0], K[1, 1], K[0, 2], K[1, 2], 0.5, 5.0]] * 4).astype(np.float32)
    pts = np.random.RandomState(8).uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
    pts[:2] = [[0.0, 0, 0], [1.5, 1.5, 1.5]]
    args = (arr["masks"][0], arr["w2c"], persps)
    keep = trender.visual_hull_mask(_t(pts), *map(_t, args), 32, 32).numpy()
    np.testing.assert_array_equal(keep, np.asarray(jrender.visual_hull_mask(jnp.asarray(pts), *map(jnp.asarray, args),
                                                                            32, 32)))
    assert keep[0] and not keep[1] and 0 < keep.mean() < 1
    args = (arr["smpl_depth"][0], arr["w2c"], persps)
    vis = trender.smpl_visibility(_t(pts), *map(_t, args), 32, 32).numpy()
    np.testing.assert_array_equal(vis, np.asarray(jrender.smpl_visibility(jnp.asarray(pts), *map(jnp.asarray, args),
                                                                          32, 32)))
    assert vis.shape == (300, 4) and 0 < vis.mean() < 1


@pytest.mark.parametrize("white", [False, True])
def test_composite_matches_jax(white):
    rng = np.random.RandomState(9)
    R, S, V = 6, 8, 3
    rgb, sigma = rng.randn(R, S, 3).astype(np.float32), (3 * rng.randn(R, S)).astype(np.float32)
    t = np.broadcast_to(np.linspace(0, 1, S, dtype=np.float32), (R, S)).copy()
    norm = rng.rand(R, 1).astype(np.float32)
    att = rng.rand(R, S, V + 1).astype(np.float32)
    att /= att.sum(-1, keepdims=True)
    src = rng.rand(R, S, V, 3).astype(np.float32)
    noise = rng.randn(R, S).astype(np.float32)
    want = jrender.composite_gnr(*map(jnp.asarray, (rgb, sigma + noise, t, norm)), att=jnp.asarray(att),
                                 source_rgb=jnp.asarray(src), white_bkgd=white)
    got = trender.composite_gnr(*map(_t, (rgb, sigma, t, norm)), att=_t(att), source_rgb=_t(src), white_bkgd=white,
                                noise=_t(noise))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], what=k)


def test_weighted_softmax_and_field_match_jax():
    from xrnerf_tpu.models.fields.gnr_mlp import GNRMLP as JMLP, weighted_softmax as jws
    from xrnerf_torch.models.fields.gnr_mlp import GNRMLP, weighted_softmax

    rng = np.random.RandomState(10)
    att, w = rng.randn(5, 4).astype(np.float32), rng.rand(5, 3).astype(np.float32)
    w[0, 1] = 0.0
    _close(weighted_softmax(_t(att), _t(w)), jws(jnp.asarray(att), jnp.asarray(w)))
    P, V = 10, 3
    inputs = (rng.randn(P, 3), rng.randn(P, V, 8), rng.randn(P, 7), rng.randn(P, V + 1, 3), rng.rand(P, V))
    inputs = [x.astype(np.float32) for x in inputs]
    for occ_net in (False, True):
        jm = JMLP(depth=4, width=32, skips=(1, 2), num_views=V, use_occlusion_net=occ_net)
        params = jm.init(jax.random.PRNGKey(0), *map(jnp.asarray, inputs[:4]))["params"]
        params = jax.tree_util.tree_map(lambda p: p + 0.1 * jnp.asarray(rng.randn(*p.shape).astype(np.float32)), params)
        m = _bridge_flax(GNRMLP(depth=4, width=32, skips=(1, 2), num_views=V, use_occlusion_net=occ_net,
                                feat_dim=8, smpl_dim=7), params)
        for alpha_only in (False, True):
            want = jm.apply({"params": params}, *map(jnp.asarray, inputs), alpha_only=alpha_only)
            got = m(*map(_t, inputs), alpha_only=alpha_only)
            assert sorted(got) == sorted(want)
            for k in want:
                _close(got[k], want[k], what=f"{k} occ_net={occ_net}")


# --- the network, on the synthetic GeneBody fixture ---


@pytest.fixture(scope="module")
def gb_arrays():
    return make_synthetic_genebody(n_frames=2, n_cams=6, H=32, W=32)


@pytest.fixture(scope="module")
def datasets(gb_arrays):
    from xrnerf_tpu.datasets.genebody import GeneBodyDataset as JDS

    return JDS(arrays=gb_arrays, N_rand=16, **DS_KW), build_dataset(
        dict(type="GeneBodyDataset", arrays=gb_arrays, N_rand=16, **DS_KW))


@pytest.fixture(scope="module")
def bridged(datasets):
    """The JAX network at ``NET_KW`` with flax's init perturbed by a seeded
    N(0, 0.1) (zero biases would hide bias paths), and the port's network
    with the same weights."""
    from xrnerf_tpu.models.networks.gnr import GnrNetwork as JNet

    jds, _ = datasets
    jnet = JNet(**NET_KW)
    params = jnet.init(jax.random.PRNGKey(0), _jb(jds.train_batch(0)), rng=None, train=False)["params"]
    rng = np.random.RandomState(11)
    params = jax.tree_util.tree_map(lambda p: p + 0.1 * jnp.asarray(rng.randn(*p.shape).astype(np.float32)), params)
    net = build_network(dict(type="GnrNetwork", **NET_KW), device="cpu")
    return jnet, params, _bridge_flax(net, params)


def test_genebody_dataset_matches_jax(datasets, gb_arrays):
    from xrnerf_tpu.datasets import genebody as jgb
    from xrnerf_torch.datasets import genebody as tgb

    jds, ds = datasets
    assert ds.input_views == jds.input_views and ds.query_views == jds.query_views
    assert ds.test_pairs == jds.test_pairs and ds.num_val == jds.num_val and ds.num_test == jds.num_test
    for step in (0, 3, 17):
        a, b = ds.train_batch(step), jds.train_batch(step)
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    b = ds.train_batch(0)
    assert b["rays_s"].shape == (16, 3) and b["ctx_images"].shape == (4, 32, 32, 3) and b["ctx_persps"].shape == (5, 6)
    for i in ds.i_test:
        (ra, ga), (rb, gb) = ds.eval_item(int(i)), jds.eval_item(int(i))
        np.testing.assert_array_equal(ga, gb)
        for k in rb:
            np.testing.assert_array_equal(ra[k], rb[k], err_msg=k)
    np.testing.assert_array_equal(ds.render_poses, jds.render_poses)
    (ra, hwa), (rb, hwb) = ds.spiral_item(ds.render_poses[3]), jds.spiral_item(jds.render_poses[3])
    assert hwa == hwb == (32, 32)
    for k in rb:
        np.testing.assert_array_equal(ra[k], rb[k], err_msg=k)
    m = gb_arrays["masks"][0, 0]
    assert tgb.image_cropping(m) == jgb.image_cropping(m)
    assert tgb.get_near_far(gb_arrays["smpl_verts"][0], gb_arrays["w2c"][0]) == jgb.get_near_far(
        gb_arrays["smpl_verts"][0], gb_arrays["w2c"][0])
    rv = np.array([0.3, -0.2, 0.5])
    np.testing.assert_array_equal(tgb._rodrigues(rv), jgb._rodrigues(rv))


def _tie_rays(net, jbatch, tbatch, ray_idx=None):
    """Rays with a sample in the visual hull whose nearest face differs from
    JAX's or whose winding number is within 1e-5 of 0.5."""
    from xrnerf_tpu.ops.mesh import nearest_points as jnearest, winding_number as jwinding
    from xrnerf_torch.ops.mesh import nearest_points

    pts, _ = trender.sample_segment(tbatch["rays_s"], tbatch["rays_e"], net.n_samples)
    R, S = pts.shape[:2]
    flat = pts.reshape(-1, 3)
    verts, faces = tbatch["ctx_smpl_verts"], tbatch["ctx_smpl_faces"]
    ti = nearest_points(flat, verts, faces, chunk=net.mesh_chunk)[1].numpy()
    ji = np.asarray(jnearest(jnp.asarray(flat.numpy()), jbatch["ctx_smpl_verts"], jbatch["ctx_smpl_faces"],
                             chunk=net.mesh_chunk)[1])
    w = np.asarray(jwinding(jnp.asarray(flat.numpy()), jbatch["ctx_smpl_verts"], jbatch["ctx_smpl_faces"]))
    keep = trender.visual_hull_mask(flat, tbatch["ctx_masks"][:4], tbatch["ctx_calibs"][:4], tbatch["ctx_persps"][:4],
                                    net.load_size, net.load_size).numpy()
    tie = keep & ((ti != ji) | (np.abs(w - 0.5) <= 1e-5))
    return tie.reshape(R, S).any(1)


def _close_rays(got, want, ties, what):
    """The f32 bar on rays without a near-tie sample, ``TIE_ATOL`` on the rest."""
    got, want = _np(got), np.asarray(want)
    _close(got[~ties], want[~ties], what=what)
    _close(got[ties], want[ties], rtol=0, atol=TIE_ATOL, what=what)


def test_network_outputs_and_loss_match_jax(bridged, datasets, capsys):
    jnet, params, net = bridged
    jds, ds = datasets
    for step in (0, 5):
        jb, tb = _jb(jds.train_batch(step)), _tb(ds.train_batch(step))
        want = jnet.apply({"params": params}, jb, rng=None, train=False)
        got = net(tb, train=False)
        assert sorted(got) == sorted(want) == ["acc", "att_rgb", "depth", "disp", "nerf_rgb", "rgb"]
        ties = _tie_rays(net, jb, tb)
        with capsys.disabled():
            print(f"\nstep {step}: {int(ties.sum())} of {len(ties)} rays hold a near-tie sample")
        for k in want:
            _close_rays(got[k], want[k], ties, k)
        assert float(np.asarray(want["acc"]).max()) > 0.1
        if not ties.any():
            jl, jlog = jnet.loss(want, jb)
            loss, log = net.loss(got, tb)
            assert sorted(log) == sorted(jlog) == ["att_mse", "loss", "nerf_mse", "psnr"]
            for k in jlog:
                _close(log[k], jlog[k], what=k)


def test_network_loss_gradients_match_jax(bridged, datasets):
    """Per-leaf loss gradients on the deterministic path (JAX ``train=False``,
    the port ``train=True`` without a generator) at the f32 bar; the encoder
    (``train_encoder=False``) gets none on either side."""
    jnet, params, net = bridged
    jds, ds = datasets
    jb, tb = _jb(jds.train_batch(1)), _tb(ds.train_batch(1))
    assert not _tie_rays(net, jb, tb).any()

    def lf(p):
        return jnet.loss(jnet.apply({"params": p}, jb, rng=None, train=False), jb)[0]

    jl, jg = jax.value_and_grad(lf)(params)
    net.zero_grad(set_to_none=True)
    loss = net.loss(net(tb, generator=None, train=True), tb)[0]
    loss.backward()
    _close(loss, jl)
    assert all(p.grad is None for p in net.image_filter.parameters())
    assert all(not np.any(np.asarray(x)) for x in jax.tree_util.tree_leaves(jg["image_filter"]))
    n_leaves = len(jax.tree_util.tree_leaves(jg))
    assert n_leaves == len(list(net.parameters()))
    # value2's bias adds the same b . key to every candidate's logit, which the
    # softmax cancels: its gradient is zero but for rounding on both sides
    got, want = port_grads(net), jax.tree_util.tree_map(np.asarray, jg)
    zero = [got["nerf"]["value2"].pop("bias"), want["nerf"]["value2"].pop("bias")]
    assert max(float(np.abs(z).max()) for z in zero) < 1e-6 * float(np.abs(want["nerf"]["value2"]["kernel"]).max())
    check_grads(got, want, n_leaves - 1)


def test_training_draws_come_from_the_generator(bridged, datasets):
    """``train=True`` with a generator jitters the samples and adds density
    noise: the same generator seed gives the same bits, another seed other
    values, and gradients reach the field and not the encoder."""
    _, _, net = bridged
    _, ds = datasets
    tb = _tb(ds.train_batch(2))
    outs = []
    for seed in (3, 3, 4):
        net.zero_grad(set_to_none=True)
        out = net(tb, generator=torch.Generator().manual_seed(seed), train=True)
        net.loss(out, tb)[0].backward()
        outs.append(out["rgb"].detach())
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert net.nerf.alpha0.weight.grad is not None and net.image_filter.conv1.weight.grad is None


def test_vh_compaction_matches_full(bridged, datasets):
    """A budget that holds every hull point (75 % here) reproduces the full
    render, in both packages."""
    from xrnerf_tpu.models.networks.gnr import GnrNetwork as JNet

    jnet, params, net = bridged
    jds, ds = datasets
    tb = _tb(ds.train_batch(0))
    full = net(tb, train=False)
    kw = dict(NET_KW, vh_compact_frac=0.75)
    cnet = build_network(dict(type="GnrNetwork", **kw), device="cpu")
    cnet.load_state_dict(net.state_dict())
    comp = cnet(tb, train=False)
    jcomp = JNet(**kw).apply({"params": params}, _jb(jds.train_batch(0)), rng=None, train=False)
    for k in ("rgb", "acc"):
        _close(comp[k], full[k], rtol=0, atol=1e-6, what=k)
        _close_rays(comp[k], jcomp[k], _tie_rays(net, _jb(jds.train_batch(0)), tb), k)


def test_query_density_color_and_reconstruct_match_jax(bridged, datasets):
    from xrnerf_tpu.models.renders.gnr_render import reconstruct_gnr as jrecon
    from xrnerf_torch.models.renders.gnr_render import reconstruct_gnr

    jnet, params, net = bridged
    jds, ds = datasets
    jb, tb = _jb(jds.train_batch(0)), _tb(ds.train_batch(0))
    pts = np.random.RandomState(12).uniform(-0.35, 0.35, (200, 3)).astype(np.float32)
    nrm = np.random.RandomState(13).randn(200, 3).astype(np.float32)
    with torch.inference_mode():
        dens = net.query_density(tb, _t(pts))
        col = net.query_color(tb, _t(pts), _t(nrm))
    jd = np.asarray(jnet.apply({"params": params}, jb, jnp.asarray(pts), method=jnet.query_density))
    jc = np.asarray(jnet.apply({"params": params}, jb, jnp.asarray(pts), jnp.asarray(nrm), method=jnet.query_color))
    from xrnerf_tpu.ops.mesh import nearest_points as jnearest
    from xrnerf_torch.ops.mesh import nearest_points

    tie = nearest_points(_t(pts), tb["ctx_smpl_verts"], tb["ctx_smpl_faces"], 128)[1].numpy() != np.asarray(
        jnearest(jnp.asarray(pts), jb["ctx_smpl_verts"], jb["ctx_smpl_faces"], 128)[1])
    _close_rays(dens, jd, tie, "density")
    _close_rays(col, jc, tie, "colour")
    assert 0 < float((jd > 0.5).mean()) < 1

    # the grid spans +-0.5 around the body's centre (the rig's own spatial_freq spans +-0.025, inside the sphere)
    kw = dict(center=np.asarray(jb["ctx_center"]), spatial_freq=32.0, load_size=32, n_grid=24, chunk=4096, laplacian=1)
    verts, faces, rgbs = reconstruct_gnr(lambda p: net.query_density(tb, p), lambda p, n: net.query_color(tb, p, n),
                                         **kw)
    jv, jf, jrgb = jrecon(lambda p: jnet.apply({"params": params}, jb, p, method=jnet.query_density),
                          lambda p, n: jnet.apply({"params": params}, jb, p, n, method=jnet.query_color), **kw)
    assert len(faces) > 100 and rgbs.shape == (len(verts), 3)
    # a near-tie grid point can move an iso-crossing, which renumbers the welded
    # vertices after it: compare the meshes by geometry, not by index
    assert abs(len(faces) - len(jf)) <= 0.02 * len(jf)
    d = np.sqrt(((verts[:, None] - jv[None]) ** 2).sum(-1))
    near = d.argmin(1)
    hit = d.min(1) <= 1e-4
    assert hit.mean() >= 0.98, hit.mean()
    _close(rgbs[hit], jrgb[near[hit]], rtol=0, atol=TIE_ATOL)


def test_render_image_matches_jax(bridged, datasets, capsys):
    """``Trainer.render_image`` of a held-out view (1,024 rays in chunks of
    300, the last padded) against the JAX renderer, the context whole in
    every chunk."""
    from xrnerf_tpu.core.renderer import render_image as jrender_image

    jnet, params, net = bridged
    jds, ds = datasets
    tr = Trainer(net, ds, work_dir=None, eval_chunk=300, device="cpu")
    tr.network.load_state_dict({k: _t(v) for k, v in state_dict_from_jax(params).items()})

    def apply_fn(p, bb, rng):
        return jnet.apply({"params": p}, bb, rng=None, train=False)

    rays, gt = ds.eval_item(0)
    got = tr.render_image(rays, 32, 32)
    want = jrender_image(apply_fn, params, jds.eval_item(0)[0], 32, 32, chunk=300)
    ties = _tie_rays(net, _jb(rays), _tb(rays))
    with capsys.disabled():
        print(f"\nheld-out view: {int(ties.sum())} of {len(ties)} rays hold a near-tie sample")
    assert ties.mean() < 0.1
    for k in ("rgb", "acc", "disp"):
        _close_rays(got[k].reshape(-1, *got[k].shape[2:]), want[k].reshape(-1, *want[k].shape[2:]), ties, k)
    assert float(want["acc"].max()) > 0.5 and got["rgb"].shape == gt.shape


def test_weights_cross_both_ways(bridged):
    jnet, params, net = bridged
    back = jax_params_from_state_dict(net.state_dict())
    want = jax.tree_util.tree_map(np.asarray, params)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    assert net.state_dict()["nerf.s"].shape == (1,) and net.state_dict()["image_filter.bn1.scale"].shape == (64,)


# --- Trainer and CLI ---


def test_trainer_checkpoint_and_bitwise_resume(datasets, tmp_path):
    _, ds = datasets

    def trainer(wd, max_iters, **kw):
        return Trainer(build_network(dict(type="GnrNetwork", **NET_KW), device="cpu"), ds,
                       optimizer=dict(type="adam", lr=5e-3), work_dir=str(wd), max_iters=max_iters,
                       ckpt_interval=2, log_interval=2, eval_chunk=256, device="cpu", **kw)

    straight = trainer(tmp_path / "a", 4)
    enc0 = {k: v.clone() for k, v in straight.network.image_filter.state_dict().items()}
    assert straight.run() == 4 and np.isfinite(straight.last_logs["loss"]) and "att_mse" in straight.last_logs
    for k, v in straight.network.image_filter.state_dict().items():
        assert torch.equal(v, enc0[k]), k  # the frozen encoder does not move
    resumed = trainer(tmp_path / "b", 4, resume_from=os.path.join(str(tmp_path / "a"), "ckpt_2.pt"))
    assert resumed.start_step == 2 and resumed.run() == 4
    for (k, a), b in zip(straight.network.state_dict().items(), resumed.network.state_dict().values()):
        assert torch.equal(a, b), k


def write_genebody(root, subject, arrays):
    """Write ``make_synthetic_genebody`` arrays as a GeneBody directory:
    ``annots.npy`` (K and c2w per camera), ``image/``, ``mask/`` and
    ``smpl_depth/`` (mm, uint16) pngs per camera, ``param/`` (the SMPL-X
    global orient) and ``smpl/`` (obj) per frame."""
    import imageio.v2 as imageio

    base = os.path.join(root, subject)
    n_frames, n_cams = arrays["imgs"].shape[:2]
    cams = {"%02d" % c: {"K": arrays["K"][c], "c2w": np.linalg.inv(arrays["w2c"][c])} for c in range(n_cams)}
    os.makedirs(base, exist_ok=True)
    np.save(os.path.join(base, "annots.npy"), {"cams": cams}, allow_pickle=True)
    for f in range(n_frames):
        stem = "%04d" % f
        for c in range(n_cams):
            for sub, img in (("image", np.round(255 * arrays["imgs"][f, c])),
                             ("mask", 255 * arrays["masks"][f, c]),
                             ("smpl_depth", np.round(1000 * arrays["smpl_depth"][f, c]))):
                d = os.path.join(base, sub, "%02d" % c)
                os.makedirs(d, exist_ok=True)
                imageio.imwrite(os.path.join(d, stem + ".png"), img.astype(np.uint16 if sub == "smpl_depth" else np.uint8))
        for sub in ("param", "smpl"):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        np.save(os.path.join(base, "param", stem + ".npy"),
                {"smplx": {"global_orient": np.array([[0.0, 0.0, 0.1 * f]], np.float32)}}, allow_pickle=True)
        with open(os.path.join(base, "smpl", stem + ".obj"), "w") as fh:
            fh.writelines(f"v {x} {y} {z}\n" for x, y, z in arrays["smpl_verts"][f])
            fh.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in arrays["smpl_faces"])
    return root


def _gnr_cfg(tmp_path, datadir):
    """``configs/gnr/gnr_genebody.py`` as written (its hooks included), the
    network narrowed, the data pointed at ``datadir`` and an eval every 2 steps."""
    src = open(os.path.join(ROOT, "configs", "gnr", "gnr_genebody.py")).read()
    cfg = tmp_path / "gnr_cfg.py"
    cfg.write_text(src + f"""
model.update(n_samples=8, load_size=32, num_stack=1, num_hourglass=1, hourglass_dim=8, mlp_depth=3, mlp_width=16,
             skips=(1,), mesh_chunk=128)
data.update(datadir=r"{datadir}", frame_end=2, N_rand=32, load_size=32, input_views=(0, 1, 2, 3))
eval_chunk = 256
eval_interval = 2
log_interval = 2
""")
    return cfg


def test_cli_trains_and_tests_gnr(tmp_path, gb_arrays):
    """``run_nerf`` trains the narrowed config (``ValidateHook`` at step 2,
    ``OccupationHook``) on a GeneBody layout on disk, read the same as the
    JAX loader reads it; then ``python -m xrnerf_torch.run_nerf --test_only
    --load_from`` gives the test set's PSNR the weights give here."""
    from xrnerf_tpu.datasets.genebody import GeneBodyDataset as JDS
    from xrnerf_torch.core.hooks import TestHook

    datadir = write_genebody(str(tmp_path / "genebody"), "synth", gb_arrays)
    cfg = _gnr_cfg(tmp_path, datadir)
    tr = run_nerf.main(["--config", str(cfg), "--dataname", "synth", "--device", "cpu", "--max_iters", "2",
                        "--work_dir", str(tmp_path / "wd")])
    assert tr.step == 2 and np.isfinite(tr.last_logs["loss"]) and np.isfinite(tr.eval_metrics["psnr"])
    assert os.path.isdir(tmp_path / "wd" / "delete_me_to_stop") and os.path.exists(tmp_path / "wd" / "val_2" / "val_0.png")
    ds = tr.dataset
    jds = JDS(datadir=datadir, subject="synth", frame_end=2, N_rand=32, load_size=32, input_views=(0, 1, 2, 3))
    assert ds.imgs.shape == (2, 6, 32, 32, 3) and ds.smpl_depth is not None
    for k in ("imgs", "masks", "Ks", "w2c", "smpl_verts", "smpl_faces", "smpl_t_verts", "smpl_rot", "smpl_depth"):
        np.testing.assert_array_equal(getattr(ds, k), getattr(jds, k), err_msg=k)
    TestHook(save_img=False).on_run_end(tr)
    pt = tmp_path / "w.pt"
    torch.save(tr.network.state_dict(), pt)
    out = subprocess.run(
        [sys.executable, "-m", "xrnerf_torch.run_nerf", "--config", str(cfg), "--dataname", "synth", "--device", "cpu",
         "--test_only", "--load_from", str(pt), "--work_dir", str(tmp_path / "test_only")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.load(open(tmp_path / "test_only" / "test" / "test_results.json"))
    assert res["psnr"]["0"] == pytest.approx(tr.eval_metrics["psnr"][0], abs=1e-4)
