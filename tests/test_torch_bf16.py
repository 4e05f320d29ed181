"""The compute ``dtype`` of the port's networks, held against the JAX
package's flax ``dtype`` on the same numpy inputs and parameters
(``utils/weights.py:state_dict_from_jax``).

- Every module with a ``dtype`` in bf16 against its flax module in bf16:
  forward outputs at rtol 2e-2 / atol 8e-3 and the same output dtypes.
- The network cases (batches, configurations, bridged parameters) that
  ``tests/test_torch_bf16_networks.py`` holds end to end. Both sides round
  at the same points; they differ by a bf16 ulp where the two backends sum
  a product in another order.
- The option itself: names and ``torch`` dtypes, an unknown name raises,
  f32 stays the default with the same bits, a config dict builds the same
  network, f32 ``.pt`` and ``.msgpack`` files load into a bf16 network, and
  ``fused=True`` ignores ``dtype``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_aninerf import ani_arrays  # noqa: E402
from xrnerf_torch import build_network  # noqa: E402
from xrnerf_torch.datasets.load.synthetic import make_synthetic_genebody, make_synthetic_zju  # noqa: E402
from xrnerf_torch.utils.checkpoint import load_weights  # noqa: E402
from xrnerf_torch.utils.dtype import resolve_dtype  # noqa: E402
from xrnerf_torch.utils.weights import jax_params_from_state_dict, state_dict_from_jax  # noqa: E402

RTOL, ATOL = 2e-2, 8e-3
NET_COS, GRAD_COS, RATIO = 0.97, 0.99, (0.93, 1.07)
TORCH_OF = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _t(a):
    return torch.from_numpy(np.require(np.asarray(a, np.float32) if np.asarray(a).dtype.kind == "f"
                                       else np.asarray(a), requirements="C").copy())


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _cos(a, b):
    a, b = np.ravel(np.asarray(a, np.float64)), np.ravel(np.asarray(b, np.float64))
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _perturbed(params, seed, scale=0.1):
    """flax's init with every 1-d leaf (biases, GroupNorm's scale and bias)
    drawn N(0, scale), so the bias paths carry values."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (scale * rng.randn(*a.shape)).astype(np.float32) if a.ndim == 1 else np.asarray(a), params)


def _load(module, params):
    module.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict_from_jax(params).items()})
    return module


def _flat(out):
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return list(out) if isinstance(out, (tuple, list)) else [out]


# --- modules: flax dtype=bf16 against the port's dtype=bf16 ---


def _rand(rng, *shape, lo=None, hi=None):
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)


def _nhwc(x):
    return x.permute(0, 2, 3, 1) if isinstance(x, torch.Tensor) and x.dim() == 4 else x


def _module_case(name, rng):
    """(flax module in bf16, its numpy args, port module in bf16, the port's
    args, a map of the port's outputs to the flax layout)."""
    bf = dict(dtype=jnp.bfloat16), dict(dtype=torch.bfloat16)
    ident = lambda o: o  # noqa: E731
    if name == "NerfMLP":
        from xrnerf_tpu.models.fields.nerf_mlp import NerfMLP as J
        from xrnerf_torch.models.fields.nerf_mlp import NerfMLP as T

        x, v = _rand(rng, 64, 21), _rand(rng, 64, 9)
        return J(netdepth=4, netwidth=32, skips=(2,), **bf[0]), (x, v), \
            T(21, 9, netdepth=4, netwidth=32, skips=(2,), **bf[1]), (x, v), ident
    if name == "BungeeNerfMLP":
        from xrnerf_tpu.models.fields.bungee_mlp import BungeeNerfMLP as J
        from xrnerf_torch.models.fields.bungee_mlp import BungeeNerfMLP as T

        x, v = _rand(rng, 64, 24), _rand(rng, 64, 9)
        kw = dict(n_stages=3, netdepth_base=4, netwidth=32, skips=(2,))
        return J(**kw, **bf[0]), (x, v), T(24, 9, **kw, **bf[1]), (x, v), ident
    if name.startswith("MultiNetworkMLP"):
        from xrnerf_tpu.models.fields.kilonerf_field import MultiNetworkMLP as J
        from xrnerf_torch.models.fields.kilonerf_field import MultiNetworkMLP as T

        kw = dict(n_nets=8, hidden=16, multires=4, multires_dirs=2, capacity_factor=1.5)
        pts, d = _rand(rng, 200, 3, lo=-1, hi=1), _rand(rng, 200, 3)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        idx = rng.randint(-1, 8, 200).astype(np.int32)
        gather = name.endswith("gather")
        return J(**kw, **bf[0]), (pts, d, idx, gather), T(**kw, **bf[1]), (pts, d, idx, gather), ident
    if name == "GroupedMultiMLP":
        from xrnerf_tpu.models.fields.kilonerf_field import GroupedMultiMLP as J
        from xrnerf_torch.models.fields.kilonerf_field import GroupedMultiMLP as T

        kw = dict(n_nets=4, hidden=16, multires=4, multires_dirs=2)
        pts, d = _rand(rng, 4, 30, 3, lo=-1, hi=1), _rand(rng, 4, 30, 3)
        return J(**kw, **bf[0]), (pts, d), T(**kw, **bf[1]), (pts, d), ident
    if name == "SmplEmbedder":
        from xrnerf_tpu.models.embedders.neuralbody import SmplEmbedder as J
        from xrnerf_torch.models.embedders.neuralbody import SmplEmbedder as T

        kw = dict(n_verts=300, code_dim=4, grid_dims=(8, 9, 7), widths=(4, 4))
        verts, pts = _rand(rng, 300, 3, lo=0.2, hi=0.8), _rand(rng, 97, 3, lo=-0.1, hi=1.1)
        lo, hi = np.zeros(3, np.float32), np.ones(3, np.float32)
        return J(**kw, **bf[0]), (np.arange(300), verts, pts, lo, hi), T(**kw, **bf[1]), (verts, pts, lo, hi), ident
    if name == "NBNerfMLP":
        from xrnerf_tpu.models.fields.nb_mlp import NBNerfMLP as J
        from xrnerf_torch.models.fields.nb_mlp import NBNerfMLP as T

        args = (_rand(rng, 33, 12), _rand(rng, 33, 3), _rand(rng, 33, 3, lo=-1, hi=1), np.asarray(2, np.int32))
        kw = dict(num_frames=4, appearance_dim=8, hidden=32)
        return J(**kw, **bf[0]), args, T(in_ch=12, **kw, **bf[1]), args, ident
    if name == "BlendWeightMLP":
        from xrnerf_tpu.models.networks.aninerf import BlendWeightMLP as J
        from xrnerf_torch.models.networks.aninerf import BlendWeightMLP as T

        args = (_rand(rng, 40, 3), _rand(rng, 40, 5, lo=0, hi=1), np.asarray(1, np.int32))
        kw = dict(n_joints=5, num_frames=3, latent_dim=8, hidden=16, depth=2)
        return J(**kw, **bf[0]), args, T(**kw, **bf[1]), args, ident
    if name == "TPoseHuman":
        from xrnerf_tpu.models.networks.aninerf import TPoseHuman as J
        from xrnerf_torch.models.networks.aninerf import TPoseHuman as T

        args = (_rand(rng, 40, 3), _rand(rng, 40, 3), np.asarray(2, np.int32))
        kw = dict(num_frames=3, hidden=16, depth=2)
        return J(**kw, **bf[0]), args, T(**kw, **bf[1]), args, ident
    if name == "GroupNorm":  # flax's has no dtype: a bf16 input gives an f32 output
        import flax.linen as nn
        from xrnerf_torch.models.embedders.gnr_embedder import GroupNorm

        x = (2.0 + _rand(rng, 2, 5, 6, 64)).astype(jnp.bfloat16)
        return nn.GroupNorm(num_groups=32), (x,), GroupNorm(64), (_t(np.asarray(x, np.float32)).bfloat16()
                                                                 .permute(0, 3, 1, 2),), _nhwc
    if name == "ConvBlock":
        from xrnerf_tpu.models.embedders.gnr_embedder import ConvBlock as J
        from xrnerf_torch.models.embedders.gnr_embedder import ConvBlock as T

        x = _rand(rng, 2, 8, 8, 64)
        return J(128, **bf[0]), (x,), T(64, 128, **bf[1]), (_t(x).permute(0, 3, 1, 2),), _nhwc
    if name == "HourGlass":
        from xrnerf_tpu.models.embedders.gnr_embedder import HourGlass as J
        from xrnerf_torch.models.embedders.gnr_embedder import HourGlass as T

        x = _rand(rng, 2, 8, 8, 128)
        return J(2, 128, **bf[0]), (x,), T(2, 128, **bf[1]), (_t(x).permute(0, 3, 1, 2),), _nhwc
    if name == "HGFilter":
        from xrnerf_tpu.models.embedders.gnr_embedder import HGFilter as J
        from xrnerf_torch.models.embedders.gnr_embedder import HGFilter as T

        x = _rand(rng, 2, 32, 32, 3, lo=0, hi=1)
        kw = dict(num_stack=2, num_hourglass=1, hourglass_dim=8, hg_down="conv128")
        return J(**kw, **bf[0]), (x,), T(**kw, **bf[1]), (_t(x).permute(0, 3, 1, 2),), _nhwc
    if name == "SRFilters":
        from xrnerf_tpu.models.embedders.gnr_embedder import SRFilters as J
        from xrnerf_torch.models.embedders.gnr_embedder import SRFilters as T

        feat, imgs = _rand(rng, 2, 8, 8, 16), _rand(rng, 2, 32, 32, 3, lo=0, hi=1)
        return J(order=2, out_ch=8, **bf[0]), (feat, imgs), T(order=2, out_ch=8, in_ch=16, **bf[1]), \
            (_t(feat).permute(0, 3, 1, 2), _t(imgs).permute(0, 3, 1, 2)), _nhwc
    if name == "GNRMLP":
        from xrnerf_tpu.models.fields.gnr_mlp import GNRMLP as J
        from xrnerf_torch.models.fields.gnr_mlp import GNRMLP as T

        P, V = 40, 3
        args = (_rand(rng, P, 3, lo=-1, hi=1), _rand(rng, P, V, 11), _rand(rng, P, 7), _rand(rng, P, V + 1, 3),
                (rng.rand(P, V) > 0.3).astype(np.float32))
        kw = dict(depth=3, width=32, skips=(1,), num_views=V, use_occlusion_net=True)
        return J(**kw, **bf[0]), args, T(**kw, feat_dim=11, smpl_dim=7, **bf[1]), args, ident
    raise KeyError(name)


MODULES = ["NerfMLP", "BungeeNerfMLP", "MultiNetworkMLP_scatter", "MultiNetworkMLP_gather", "GroupedMultiMLP",
           "SmplEmbedder", "NBNerfMLP", "BlendWeightMLP", "TPoseHuman", "GroupNorm", "ConvBlock", "HourGlass",
           "HGFilter", "SRFilters", "GNRMLP"]


@pytest.mark.parametrize("name", MODULES)
def test_module_bf16_matches_flax(name):
    rng = np.random.RandomState(MODULES.index(name))
    jm, jargs, tm, targs, to_flax = _module_case(name, rng)
    jargs = tuple(a if isinstance(a, bool) else jnp.asarray(a) for a in jargs)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), *jargs)["params"], seed=1)
    if name == "GroupNorm":
        params = {"scale": 1.0 + params["scale"], "bias": params["bias"]}
    want = _flat(jm.apply({"params": params}, *jargs))
    targs = tuple(_t(a) if isinstance(a, np.ndarray) else a for a in targs)
    with torch.no_grad():
        got = [to_flax(g) for g in _flat(_load(tm, params)(*targs))]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == TORCH_OF[jnp.dtype(w.dtype)], f"output {i}: {g.dtype} vs flax {w.dtype}"
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32), rtol=RTOL, atol=ATOL, err_msg=f"output {i}")


# --- networks end to end in bf16 ---


def _rays(n, seed, near=2.0, far=6.0):
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return {"rays_o": (0.3 * rng.randn(n, 3)).astype(np.float32), "rays_d": d,
            "near": np.full((n, 1), near, np.float32), "far": np.full((n, 1), far, np.float32),
            "target": rng.rand(n, 3).astype(np.float32)}


def _network_case(name):
    """(JAX class, port type, kwargs, numpy batch, JAX apply extras, the
    port's set-up of the same extras, leaves whose gradient is rounding alone)."""
    none = lambda net: None  # noqa: E731
    if name == "NerfNetwork":
        from xrnerf_tpu.models.networks.nerf import NerfNetwork as J

        return J, dict(n_samples=16, n_importance=16, netdepth=4, netwidth=32, perturb=False), _rays(64, 0), {}, \
            none, ()
    if name == "MipNerfNetwork":
        from xrnerf_tpu.models.networks.mipnerf import MipNerfNetwork as J

        b = _rays(64, 1)
        rng = np.random.RandomState(1)
        b["radii"] = rng.uniform(5e-4, 3e-3, (64, 1)).astype(np.float32)
        b["lossmult"] = (4.0 ** rng.randint(0, 4, (64, 1))).astype(np.float32)
        return J, dict(num_levels=2, n_samples=16, netdepth=4, netwidth=32), b, {}, none, ()
    if name == "KiloNerfNetwork":
        from xrnerf_tpu.models.networks.kilonerf import KiloNerfNetwork as J

        occ = np.random.RandomState(3).rand(8, 8, 8) < 0.3
        return J, dict(resolution=(4, 4, 4), hidden=16, multires=4, multires_dirs=2, n_samples=48, n_keep=16,
                       capacity_factor=8.0), _rays(48, 2, near=0.5, far=2.0), dict(aux=jnp.asarray(occ)), \
            lambda net: net.set_occupancy(occ), ()
    if name == "StudentNerfNetwork":
        from xrnerf_tpu.models.networks.kilonerf import StudentNerfNetwork as J

        rng = np.random.RandomState(4)
        d = rng.randn(400, 3).astype(np.float32)
        b = {"pts": rng.uniform(-1, 1, (400, 3)).astype(np.float32), "dirs": d / np.linalg.norm(d, axis=-1,
                                                                                                 keepdims=True),
             "target_rgb": rng.rand(400, 3).astype(np.float32), "target_sigma": rng.rand(400).astype(np.float32)}
        return J, dict(resolution=(2, 2, 2), hidden=16, multires=4, multires_dirs=2), b, {}, none, ()
    if name == "BungeeNerfNetwork":
        from xrnerf_tpu.models.networks.bungeenerf import BungeeNerfNetwork as J

        b = _rays(48, 5, near=1.0, far=4.0)
        rng = np.random.RandomState(5)
        b.update(radii=rng.uniform(5e-3, 2e-2, (48, 1)).astype(np.float32),
                 scale_code=rng.randint(0, 3, (48, 1)).astype(np.float32), stage=np.asarray(2, np.int32))
        return J, dict(n_stages=3, n_samples=8, netwidth=32, max_deg_point=6), b, {}, none, ()
    if name == "NeuralBodyNetwork":
        from xrnerf_tpu.datasets.neuralbody import NeuralBodyDataset as JDS

        from xrnerf_tpu.models.networks.neuralbody import NeuralBodyNetwork as J

        zju = make_synthetic_zju(n_frames=2, n_cams=4, H=24, W=24, n_verts=200)
        b = JDS(arrays=zju, N_rand=32, training_view=(0, 1, 2)).train_batch(6)
        return J, dict(n_verts=200, code_dim=4, grid_dims=(16, 16, 16), conv_widths=(8, 8, 8), num_frames=4,
                       appearance_dim=8, hidden=32, n_samples=8), b, {}, none, ()
    if name.startswith("AniNeRFNetwork"):
        from xrnerf_tpu.datasets.aninerf import AniNeRFDataset as JDS
        from xrnerf_tpu.models.networks.aninerf import AniNeRFNetwork as J

        b = JDS(arrays=ani_arrays(), N_rand=16, training_view=(0, 1)).train_batch(3)
        phase = name.split("_", 1)[1]
        return J, dict(n_joints=3, num_frames=4, n_samples=8, hidden=32, smpl_dist_threshold=0.2, phase=phase), \
            b, {}, none, ()
    if name == "GnrNetwork":
        from xrnerf_tpu.datasets.genebody import GeneBodyDataset as JDS
        from xrnerf_tpu.models.networks.gnr import GnrNetwork as J

        arrays = make_synthetic_genebody(n_frames=2, n_cams=6, H=32, W=32)
        b = JDS(arrays=arrays, N_rand=16, num_views=4, input_views=(0, 1, 2, 3)).train_batch(1)
        # value2's bias adds one b . key to every candidate's logit, which the softmax cancels
        return J, dict(num_views=4, n_samples=8, load_size=32, num_stack=1, num_hourglass=1, hourglass_dim=8,
                       mlp_depth=3, mlp_width=16, skips=(1,), mesh_chunk=128), b, {}, none, ("nerf.value2.bias",)
    raise KeyError(name)


NETWORKS = ["NerfNetwork", "MipNerfNetwork", "KiloNerfNetwork", "StudentNerfNetwork", "BungeeNerfNetwork",
            "NeuralBodyNetwork", "AniNeRFNetwork_train_pose", "AniNeRFNetwork_novel_pose", "GnrNetwork"]


def _bridged_pair(name):
    """(flax network in bf16, its perturbed params, the port's network in
    bf16 holding them, numpy batch, JAX apply extras)."""
    jcls, kw, b, jextra, setup, rounding = _network_case(name)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    params = jcls(**kw).init(jax.random.PRNGKey(0), jb, rng=None, train=False, **jextra)["params"]
    if name == "GnrNetwork":  # as tests/test_torch_gnr.py perturbs it: every leaf, so no head starts dead
        rng = np.random.RandomState(11)
        params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.1 * rng.randn(*a.shape).astype(np.float32),
                                        params)
    else:
        params = _perturbed(params, seed=2, scale=0.05)
    if name == "NeuralBodyNetwork":
        params["mlp"]["alpha"]["bias"] = np.full((1,), 2.0, np.float32)  # the box renders
    if name.startswith("AniNeRF"):
        params["tpose_human"]["density_out"]["bias"] = np.full((1,), 2.0, np.float32)
    net = build_network(dict(type=jcls.__name__, **kw, dtype="bfloat16"), device="cpu")
    setup(net)
    return jcls(**kw, dtype=jnp.bfloat16), params, _load(net, params), b, jextra, rounding


# --- the option ---


@pytest.mark.parametrize("name,want", [("float32", torch.float32), ("bfloat16", torch.bfloat16),
                                       ("float16", torch.float16), (torch.bfloat16, torch.bfloat16)])
def test_dtype_names(name, want):
    assert resolve_dtype(name) is want


@pytest.mark.parametrize("bad", ["bf16", "float64", torch.float64, None, 16])
def test_unknown_dtype_raises(bad):
    with pytest.raises(ValueError, match="unknown compute dtype"):
        resolve_dtype(bad)
    with pytest.raises(ValueError, match="unknown compute dtype"):
        build_network(dict(type="NerfNetwork", netdepth=2, netwidth=16, dtype=bad), device="cpu")


def _seeded(cfg):
    """flax's init from a seed, every 1-d leaf drawn N(0, 0.05)."""
    net = build_network(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    net.reset_parameters(gen)
    with torch.no_grad():
        for p in net.parameters():
            if p.dim() == 1:
                p.copy_(0.05 * torch.randn(p.shape, generator=gen))
    return net


@pytest.mark.parametrize("name", NETWORKS)
def test_default_is_f32_and_a_name_builds_the_same_network(name):
    """f32 is the default (no argument, ``"float32"`` and ``torch.float32``
    give the same bits), every parameter stays f32 in bf16, and
    ``dtype="bfloat16"`` from a config dict is ``dtype=torch.bfloat16``."""
    jcls, kw, b, _, setup, _ = _network_case(name)
    tb = {k: _t(v) for k, v in b.items()}
    outs = {}
    for tag, extra in (("default", {}), ("f32_name", dict(dtype="float32")), ("f32", dict(dtype=torch.float32)),
                       ("bf16_name", dict(dtype="bfloat16")), ("bf16", dict(dtype=torch.bfloat16))):
        net = _seeded(dict(type=jcls.__name__, **kw, **extra))
        setup(net)
        assert all(p.dtype == torch.float32 for p in net.parameters())
        assert {m.dtype for m in net.modules() if isinstance(getattr(m, "dtype", None), torch.dtype)} == \
            {torch.bfloat16 if tag.startswith("bf16") else torch.float32}
        outs[tag] = net(tb, train=False)
    for a, c in (("default", "f32_name"), ("default", "f32"), ("bf16", "bf16_name")):
        for k in outs[a]:
            assert torch.equal(outs[a][k], outs[c][k]), (a, c, k)
    assert any(not torch.equal(outs["default"][k], outs["bf16"][k]) for k in outs["default"]
               if outs["default"][k].is_floating_point())


@pytest.mark.parametrize("fmt", [".pt", ".msgpack"])
def test_bf16_network_loads_f32_checkpoints(fmt, tmp_path):
    """A bf16 network loads an f32 file (a ``.pt`` state dict, a flax
    ``.msgpack``) with its parameters f32 and equal to the file's, and its
    outputs are the JAX network's in bf16."""
    from flax.serialization import msgpack_serialize

    jnet, params, _, b, jextra, _ = _bridged_pair("NerfNetwork")
    path = str(tmp_path / f"w{fmt}")
    if fmt == ".pt":
        torch.save({k: torch.from_numpy(v) for k, v in state_dict_from_jax(params).items()}, path)
    else:
        with open(path, "wb") as f:
            f.write(msgpack_serialize({"params": jax.tree_util.tree_map(np.asarray, params)}))
    net = build_network(dict(type="NerfNetwork", n_samples=16, n_importance=16, netdepth=4, netwidth=32,
                             perturb=False, dtype="bfloat16"), device="cpu")
    load_weights(net, path)
    back = jax_params_from_state_dict({k: p.detach().numpy() for k, p in net.named_parameters()})
    for (path_, a), (_, c) in zip(jax.tree_util.tree_leaves_with_path(params), jax.tree_util.tree_leaves_with_path(back)):
        assert c.dtype == np.float32 and np.array_equal(np.asarray(a), c), jax.tree_util.keystr(path_)
    want = jnet.apply({"params": params}, {k: jnp.asarray(v) for k, v in b.items()}, rng=None, train=False)
    got = net({k: _t(v) for k, v in b.items()}, train=False)
    assert _cos(_np(got["rgb"]), want["rgb"]) > NET_COS


@pytest.mark.parametrize("train", [False, True], ids=["serve", "train"])
def test_fused_network_ignores_dtype(train):
    """``fused=True`` runs rows 1-2 whatever ``dtype`` says, as in JAX: the
    same bits, and the same gradients, with ``dtype`` bf16 as with f32."""
    kw = dict(type="NerfNetwork", n_samples=8, n_importance=8, fused=True, perturb=False)
    tb = {k: _t(v) for k, v in _rays(32, 9).items()}
    outs, grads = [], []
    for dtype in ("float32", "bfloat16"):
        net = _seeded(dict(kw, dtype=dtype))
        out = net(tb, generator=None, train=train)
        outs.append(out)
        if train:
            net.loss(out, tb)[0].backward()
            grads.append({k: p.grad for k, p in net.named_parameters()})
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k
    for k in (grads[0] if train else {}):
        assert torch.equal(grads[0][k], grads[1][k]), k

