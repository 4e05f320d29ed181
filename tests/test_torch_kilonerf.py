"""The KiloNeRF slice of the PyTorch port, held against the JAX package on the
same numpy inputs: ``ops/compaction.py:keep_first_k``, the multi-network field
(``assign_networks``, ``moe_dispatch``, both dispatches of
``MultiNetworkMLP``, ``GroupedMultiMLP``), the three marches with their
distance field, bitfields and strip-culling prepass, ``KiloNerfNetwork``
(full eval, train path, fast path, ``eval_budget`` compaction, loss and
``param_loss`` gradients), ``StudentNerfNetwork``, ``build_occupancy_grid``,
both datasets, the renderer's ``active_fn`` culling, ``Trainer`` with the
occupancy grid and ``param_loss`` against the JAX trainer, and the CLI on a
cut of ``configs/kilonerf/kilonerf_finetune.py``.

Tolerances. Discrete outputs (indices, masks, kept lattice positions,
distance fields, grids) are equal. Forwards are f32 on both sides: rtol 1e-4 /
atol 1e-5. Gradients per leaf: cosine > 0.999 and norm ratio within 1e-3 of
1. The JAX package compiles ``lax.scan`` bodies (the sphere march) as one
fusion, where XLA contracts ``a + b * c`` into a fused multiply-add, and
divides by a constant as a product with its reciprocal (``jnp.linspace``);
the port computes those expressions the same way, so kept z values are equal
too.
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

import xrnerf_tpu.models.fields.kilonerf_field as jfield  # noqa: E402
import xrnerf_tpu.models.networks.kilonerf as jkilo  # noqa: E402
import xrnerf_torch.models.fields.kilonerf_field as tfield  # noqa: E402
import xrnerf_torch.models.networks.kilonerf as tkilo  # noqa: E402
from xrnerf_torch import run_nerf  # noqa: E402
from xrnerf_torch.core.renderer import render_rays_chunked  # noqa: E402
from xrnerf_torch.core.trainer import Trainer  # noqa: E402
from xrnerf_torch.utils.weights import jax_params_from_state_dict, state_dict_from_jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
MIN_COS, RATIO_TOL = 0.999, 1e-3
DMIN, DMAX = (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=what)


def _equal(got, want, what=""):
    np.testing.assert_array_equal(_np(got), _np(want), err_msg=what)


def _leaves_close(got, want):
    """Per leaf: cosine > 0.999, norm ratio within 1e-3 of 1."""
    for k in want:
        a, b = np.ravel(_np(got[k])).astype(np.float64), np.ravel(_np(want[k])).astype(np.float64)
        if not np.any(b):
            assert not np.any(a), k
            continue
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        ratio = np.linalg.norm(a) / np.linalg.norm(b)
        assert cos > MIN_COS and abs(ratio - 1) < RATIO_TOL, (k, cos, ratio)


def _rays(n, seed, scale_norms=False, near=0.5, far=2.0):
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if scale_norms:  # camera-style directions, norms up to 1.4
        d *= (1.0 + 0.4 * rng.rand(n, 1)).astype(np.float32)
    return {
        "rays_o": (rng.randn(n, 3) * 0.1).astype(np.float32),
        "rays_d": d,
        "near": np.full((n, 1), near, np.float32),
        "far": np.full((n, 1), far, np.float32),
        "target": rng.rand(n, 3).astype(np.float32),
    }


def _march_args(b, occ, pkg):
    conv = _j if pkg == "jax" else _t
    return (conv(b["rays_o"]), conv(b["rays_d"]), conv(b["near"]), conv(b["far"]), conv(occ),
            conv(np.float32(DMIN)), conv(np.float32(DMAX)))


# --- ops/compaction.py ---


@pytest.mark.parametrize("k", [1, 8, 48])
def test_keep_first_k_matches_jax(k):
    from xrnerf_tpu.ops.compaction import keep_first_k as jkeep

    from xrnerf_torch.ops.compaction import keep_first_k

    rng = np.random.RandomState(k)
    live = rng.rand(32, 48) < 0.3
    live[0] = True  # a full row
    live[1] = False  # an empty one
    vals = rng.rand(32, 48).astype(np.float32)
    want = jkeep(_j(live), k, _j(vals))
    got = keep_first_k(_t(live), k, _t(vals))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    for g, w, name in zip(got, want, ("idx", "mask", "vals")):
        _equal(g, w, name)
    for g, w in zip(keep_first_k(_t(live), k), jkeep(_j(live), k)):
        _equal(g, w)


# --- models/fields/kilonerf_field.py ---


@pytest.mark.parametrize("res", [(2, 2, 2), (4, 3, 5)])
def test_assign_networks_matches_jax(res):
    """Random points, points outside the domain and points on cell faces."""
    rng = np.random.RandomState(0)
    pts = rng.uniform(-1.2, 1.2, (512, 3)).astype(np.float32)
    faces = (np.stack(np.meshgrid(*[np.linspace(-1, 1, r + 1) for r in res], indexing="ij"), -1)
             .reshape(-1, 3).astype(np.float32))
    pts = np.concatenate([pts, faces, [[0.99, 0.99, 0.99], [1.0, 0.0, 0.0], [-1.0, -1.0, -1.0]]]).astype(np.float32)
    w_idx, w_local = jfield.assign_networks(_j(pts), _j(np.float32(DMIN)), _j(np.float32(DMAX)), res)
    g_idx, g_local = tfield.assign_networks(_t(pts), DMIN, DMAX, res)
    assert g_idx.dtype == torch.int32
    _equal(g_idx, w_idx, "net_idx")
    _close(g_local, w_local, what="local")
    assert int(g_idx[-3]) == int(np.prod(res)) - 1 and int(g_idx[-2]) == -1 and int(g_idx[-1]) == 0


@pytest.mark.parametrize("capacity", [2, 5, 64])
def test_moe_dispatch_matches_jax(capacity):
    rng = np.random.RandomState(capacity)
    idx = rng.randint(-1, 7, 300).astype(np.int32)
    idx[:40] = 3  # a crowded network
    want = jfield.moe_dispatch(_j(idx), 7, capacity)
    got = tfield.moe_dispatch(_t(idx), 7, capacity)
    for g, w, name in zip(got, want, ("dest", "keep", "order")):
        _equal(g, w, name)


def _field_inputs(b=513, n_nets=27, seed=1):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (b, 3)).astype(np.float32)
    d = rng.randn(b, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    idx = rng.randint(-1, n_nets, b).astype(np.int32)
    idx[:60] = 5  # over capacity at factor 1.5
    return pts, d, idx


@pytest.fixture(scope="module")
def field():
    kw = dict(n_nets=27, hidden=8, multires=4, multires_dirs=2, capacity_factor=1.5)
    jm = jfield.MultiNetworkMLP(**kw)
    pts, d, idx = _field_inputs()
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), _j(pts), _j(d), _j(idx))["params"])
    tm = tfield.MultiNetworkMLP(**kw)
    tm.load_state_dict({k: _t(v) for k, v in state_dict_from_jax(params).items()})
    return jm, params, tm


def test_field_leaf_names_match_flax(field):
    jm, params, tm = field
    assert set(tm.state_dict()) == set(state_dict_from_jax(params))
    for k, v in tm.state_dict().items():
        assert tuple(v.shape) == params[k].shape, k
    back = jax_params_from_state_dict(tm.state_dict())
    assert set(back) == set(params) and all(np.array_equal(back[k], params[k]) for k in params)


@pytest.mark.parametrize("gather", [False, True], ids=["scatter", "gather"])
def test_multinetwork_dispatch_matches_jax(field, gather):
    """Both dispatches against JAX's (same stable grouping, same capacity
    drops); the two dispatches agree with each other too."""
    jm, params, tm = field
    pts, d, idx = _field_inputs()
    want = jm.apply({"params": params}, _j(pts), _j(d), _j(idx), gather_dispatch=gather)
    with torch.no_grad():
        got = tm(_t(pts), _t(d), _t(idx), gather_dispatch=gather)
        other = tm(_t(pts), _t(d), _t(idx), gather_dispatch=not gather)
    for g, w, o, name in zip(got, want, other, ("rgb", "sigma")):
        _close(g, w, what=name)
        _close(g, o, what=name)
    kept = int(tfield.moe_dispatch(_t(idx), 27, tm.capacity(len(idx)))[1].sum())
    assert kept < int((idx >= 0).sum()) and float(got[1].min()) == -1e3  # the capacity dropped some points


def test_multinetwork_is_spatially_local(field):
    """One network's weights move only its own points' outputs."""
    _, _, tm = field
    pts, d, idx = _field_inputs()
    idx = np.where(idx < 0, 0, idx).astype(np.int32)
    with torch.no_grad():
        rgb0, sigma0 = tm(_t(pts), _t(d), _t(idx))
        tm.hidden_0_w[3] += 1.0
        rgb1, sigma1 = tm(_t(pts), _t(d), _t(idx))
        tm.hidden_0_w[3] -= 1.0
    changed = ((rgb0 != rgb1).any(-1) | (sigma0 != sigma1)).numpy()
    assert changed[idx == 3].any() and not changed[idx != 3].any()


def test_multinetwork_gradients_match_jax(field):
    """Per-leaf gradients through the scatter dispatch."""
    jm, params, tm = field
    pts, d, idx = _field_inputs()
    rng = np.random.RandomState(5)
    w_rgb, w_sig = rng.randn(len(idx), 3).astype(np.float32), rng.randn(len(idx)).astype(np.float32)

    def jloss(p):
        rgb, sigma = jm.apply({"params": p}, _j(pts), _j(d), _j(idx))
        return jnp.sum(jnp.tanh(rgb) * w_rgb) + jnp.sum(jnp.tanh(sigma / 10) * w_sig)

    jg = jax.grad(jloss)(params)
    tm.zero_grad()
    rgb, sigma = tm(_t(pts), _t(d), _t(idx))
    (torch.sum(torch.tanh(rgb) * _t(w_rgb)) + torch.sum(torch.tanh(sigma / 10) * _t(w_sig))).backward()
    _leaves_close({k: p.grad for k, p in tm.named_parameters()}, state_dict_from_jax(jg))


def test_grouped_multimlp_matches_jax():
    kw = dict(n_nets=6, hidden=16, n_hidden_layers=2, multires=4, multires_dirs=0)
    rng = np.random.RandomState(3)
    local = rng.uniform(-1, 1, (6, 40, 3)).astype(np.float32)
    dirs = rng.randn(6, 40, 3).astype(np.float32)
    jm = jfield.GroupedMultiMLP(**kw)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1), _j(local), _j(dirs))["params"])
    tm = tfield.GroupedMultiMLP(**kw)
    tm.load_state_dict({k: _t(v) for k, v in state_dict_from_jax(params).items()})
    want = jm.apply({"params": params}, _j(local), _j(dirs))
    got = tm(_t(local), _t(dirs))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)


# --- the marches ---


def test_distance_transform_and_bitfields_match_jax():
    rng = np.random.RandomState(4)
    occ = rng.rand(16, 16, 40) < 0.03  # 40 deep: two packed words, the second ragged
    want = jkilo.distance_transform_linf(_j(occ))
    got = tkilo.distance_transform_linf(_t(occ))
    assert got.dtype == torch.int32
    _equal(got, want)
    assert not bool(((got > 0) & _t(occ)).any()) and bool((got[_t(occ)] == 0).all())
    packed_j = np.asarray(jkilo._pack_z_bits(_j(occ))).astype(np.int64)
    packed_t = tkilo._pack_z_bits(_t(occ))
    _equal(packed_t, packed_j)
    cz = rng.randint(0, 40, (16 * 16,)).astype(np.int32)
    _equal(tkilo._zrow_bit(packed_t, _t(cz)), jkilo._zrow_bit(jnp.asarray(packed_j.astype(np.uint32)), _j(cz)))


@pytest.mark.parametrize("scale_norms", [False, True], ids=["unit", "camera"])
@pytest.mark.parametrize("march", ["dense", "sphere", "pooled", "pooled_ample"])
def test_march_matches_jax(march, scale_norms):
    """Kept z values, masks and dt equal JAX's (64 rays, 96 candidates, 16 kept,
    a 16^3 grid 10 % occupied); the pooled march at G 8 with 4 groups kept and
    with every group kept."""
    b = _rays(64, seed=2 + scale_norms, scale_norms=scale_norms)
    occ = np.random.RandomState(2).rand(16, 16, 16) < 0.1
    S, K = 96, 16
    if march == "dense":
        fns = (jkilo.kilonerf_march, tkilo.kilonerf_march, {})
    elif march == "sphere":
        fns = (jkilo.kilonerf_sphere_march, tkilo.kilonerf_sphere_march, dict(n_steps=40))
    else:
        kg = S // 8 if march == "pooled_ample" else 4
        fns = (jkilo.kilonerf_pooled_march, tkilo.kilonerf_pooled_march, dict(group=8, n_groups_keep=kg))
    want = fns[0](*_march_args(b, occ, "jax"), S, K, **fns[2])
    got = fns[1](*_march_args(b, occ, "torch"), S, K, **fns[2])
    for g, w, name in zip(got, want, ("z_keep", "mask", "dt")):
        _equal(g, w, name)
    assert 0 < int(got[1].sum()) < got[1].numel()


def test_pooled_and_sphere_marches_equal_dense_with_ample_budgets():
    """The same samples as the dense march (``tests/test_kilonerf.py``'s bar:
    masks equal, z within 1e-5, since each march forms z its own way)."""
    b = _rays(64, seed=9, scale_norms=True)
    occ = np.random.RandomState(9).rand(16, 16, 16) < 0.1
    args = _march_args(b, occ, "torch")
    dense = tkilo.kilonerf_march(*args, 96, 16)
    for other in (tkilo.kilonerf_pooled_march(*args, 96, 16, group=8, n_groups_keep=12),
                  tkilo.kilonerf_sphere_march(*args, 96, 16, n_steps=96)):
        _equal(other[1], dense[1], "mask")
        _close(other[0], dense[0], rtol=0, atol=1e-5, what="z_keep")
        _close(other[2], dense[2], what="dt")


def _blob_bundle(n=64, seed=7):
    """Half the rays through a 2^3 blob at the centre of a 16^3 grid, half aimed away."""
    rng = np.random.RandomState(seed)
    on = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (n // 2, 1))
    off = np.tile(np.array([1.0, 1.0, -0.2], np.float32), (n // 2, 1))
    d = (np.concatenate([on, off]) + rng.randn(n, 3).astype(np.float32) * 0.005).astype(np.float32)
    occ = np.zeros((16, 16, 16), bool)
    occ[7:9, 7:9, 7:9] = True
    rays = {"rays_o": np.tile(np.array([[0.0, 0.0, -2.5]], np.float32), (n, 1)), "rays_d": d,
            "near": np.full((n, 1), 0.5, np.float32), "far": np.full((n, 1), 4.0, np.float32)}
    return rays, occ


@pytest.mark.parametrize("case", ["coherent", "incoherent", "blob"])
def test_strip_active_matches_jax(case):
    """The culling mask equals JAX's and never culls a ray the dense march finds live."""
    rng = np.random.RandomState(11)
    if case == "blob":
        rays, occ = _blob_bundle()
    else:
        occ = rng.rand(16, 16, 16) < 0.08
        n = 128
        if case == "coherent":
            d = np.array([0.1, -0.2, 1.0], np.float32)[None] + rng.randn(n, 3).astype(np.float32) * 0.01
            o = np.tile(np.array([[0.0, 0.0, -2.5]], np.float32), (n, 1))
        else:
            d, o = rng.randn(n, 3).astype(np.float32), (rng.randn(n, 3) * 0.3).astype(np.float32)
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True) * (1.0 + 0.4 * rng.rand(n, 1))).astype(np.float32)
        rays = {"rays_o": o, "rays_d": d, "near": np.full((n, 1), 0.5, np.float32),
                "far": np.full((n, 1), 4.0, np.float32)}
    args = _march_args(rays, occ, "torch")
    dist = tkilo.distance_transform_linf(args[4])
    got = tkilo.kilonerf_strip_active(*args[:4], dist, *args[5:], strip=8, n_probes=48)
    jargs = _march_args(rays, occ, "jax")
    want = jkilo.kilonerf_strip_active(*jargs[:4], jkilo.distance_transform_linf(jargs[4]), *jargs[5:], strip=8,
                                       n_probes=48)
    _equal(got, want)
    live = tkilo.kilonerf_march(*args, 96, 16)[1].any(-1)
    assert not bool((live & ~got).any())
    if case == "blob":
        assert bool(got[:32].all()) and not bool(got[32:].any())
    # a ray count that is not a multiple of the strip: padded inside
    odd = tkilo.kilonerf_strip_active(*(a[:61] for a in args[:4]), dist, *args[5:], strip=8, n_probes=48)
    jodd = jkilo.kilonerf_strip_active(*(a[:61] for a in jargs[:4]), jkilo.distance_transform_linf(jargs[4]),
                                       *jargs[5:], strip=8, n_probes=48)
    _equal(odd, jodd)


# --- models/networks/kilonerf.py: KiloNerfNetwork ---

NET_KW = dict(resolution=(4, 4, 4), hidden=16, n_hidden_layers=2, multires=4, multires_dirs=2, n_samples=64)


def _jnet(**kw):
    return jkilo.KiloNerfNetwork(**{**NET_KW, **kw})


def _tnet(params=None, occ=None, **kw):
    net = tkilo.KiloNerfNetwork(**{**NET_KW, **kw})
    if params is not None:
        net.load_state_dict({k: _t(v) for k, v in state_dict_from_jax(params).items()})
    if occ is not None:
        net.set_occupancy(occ)
    return net


@pytest.fixture(scope="module")
def kilo():
    """JAX init params, a 8^3 grid 20 % occupied, and 32 rays."""
    rng = np.random.RandomState(3)
    occ = rng.rand(8, 8, 8) < 0.2
    b = _rays(32, seed=3)
    jb = {k: _j(v) for k, v in b.items()}
    params = _jnet(capacity_factor=8.0).init(jax.random.PRNGKey(0), jb, rng=None, train=False, aux=_j(occ))["params"]
    return jax.tree_util.tree_map(np.asarray, params), occ, b


def _jout(net, params, b, occ, train=False):
    aux = None if occ is None else _j(occ)
    return net.apply({"params": params}, {k: _j(v) for k, v in b.items()}, rng=None, train=train, aux=aux)


@pytest.mark.parametrize("occupied", [False, True], ids=["no_grid", "grid"])
def test_full_eval_matches_jax(kilo, occupied):
    """``n_keep=0`` (all 64 samples, scatter dispatch), with and without the grid."""
    params, occ, b = kilo
    occ = occ if occupied else None
    want = _jout(_jnet(n_keep=0, capacity_factor=8.0), params, b, occ)
    got = _tnet(params, occ, n_keep=0, capacity_factor=8.0)({k: _t(v) for k, v in b.items()})
    for k in ("rgb", "disp", "acc", "depth"):
        _close(got[k], want[k], what=k)


@pytest.mark.parametrize("march", ["dense", "sphere", "pooled"])
def test_fast_path_matches_jax(kilo, march):
    """ESS + keep-K eval through the gather dispatch, default capacity
    (points dropped) and an ample one."""
    params, occ, b = kilo
    for cf in (2.0, 64.0):
        kw = dict(n_keep=12, march=march, march_group=8, march_groups_keep=4, n_march_steps=48, capacity_factor=cf)
        want = _jout(_jnet(**kw), params, b, occ)
        got = _tnet(params, occ, **kw)({k: _t(v) for k, v in b.items()})
        for k in ("rgb", "disp", "acc", "depth"):
            _close(got[k], want[k], what=f"{march} {cf} {k}")


def test_fast_path_close_to_full_eval():
    """Keep-K eval against all samples on a thin central slab (only the
    compositing step differs: the fixed candidate dt against z differences)."""
    occ = np.zeros((8, 8, 8), bool)
    occ[3:5, 3:5, 3:5] = True
    rng = np.random.RandomState(0)
    d = rng.randn(32, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    b = {"rays_o": 2.0 * d, "rays_d": -d, "near": np.full((32, 1), 1.0, np.float32),
         "far": np.full((32, 1), 3.0, np.float32)}
    full = _tnet(None, occ, n_keep=0, capacity_factor=8.0)
    fast = _tnet(None, occ, n_keep=24, capacity_factor=8.0)
    fast.load_state_dict(full.state_dict())
    tb = {k: _t(v) for k, v in b.items()}
    of, oq = full(tb), fast(tb)
    assert float((of["rgb"] - oq["rgb"]).abs().max()) < 0.02
    _close(oq["acc"], of["acc"], rtol=0, atol=0.02)


def _reference_slots(mask, budget):
    """Budget slots the straightforward way: live samples ray-major, first ``budget``."""
    n, k = mask.shape
    live = np.nonzero(mask.reshape(-1))[0][:budget]
    sel = np.zeros(budget, np.int64)
    sel[: len(live)] = live
    return sel, np.arange(budget) < len(live)


def test_eval_budget_compaction_matches_jax(kilo):
    """With a budget below the live count the compaction drops the far end:
    the selected slots equal a plain ray-major live-first selection, and the
    render equals JAX's; with a budget at or above it, the render equals the
    uncompacted one."""
    params, occ, b = kilo
    kw = dict(n_keep=8, march="pooled", capacity_factor=64.0)
    net = _tnet(params, occ, **kw)
    tb = {k: _t(v) for k, v in b.items()}
    with torch.no_grad():
        mask = net.march_samples(tb)[1]
    n_live = int(mask.sum())
    assert 0 < n_live < mask.numel()
    for budget in (n_live // 2, n_live - 1, n_live, mask.numel() - 1):
        net.eval_budget = budget
        _, sel, valid = net.budget_slots(mask)
        want_sel, want_valid = _reference_slots(mask.numpy(), budget)
        _equal(valid, want_valid, f"valid at {budget}")
        _equal(sel[valid], want_sel[want_valid], f"sel at {budget}")
        if budget not in (n_live // 2, mask.numel() - 1):
            continue
        want = _jout(_jnet(**kw, eval_budget=budget), params, b, occ)
        got = net(tb)
        for k in ("rgb", "acc", "depth"):
            _close(got[k], want[k], what=f"{k} at budget {budget}")
    net.eval_budget = 0
    base = net(tb)
    net.eval_budget = n_live
    _close(net(tb)["rgb"], base["rgb"], rtol=0, atol=0)


def test_train_path_loss_and_param_loss_match_jax(kilo):
    """The train path (stratified samples, occupancy masking, scatter
    dispatch, ``volume_render``) without jitter: outputs, loss, ``param_loss``
    and the gradients of their sum per leaf."""
    params, occ, b = kilo
    jnet = _jnet(capacity_factor=2.0, view_dep_reg=1e-3)
    net = _tnet(params, occ, capacity_factor=2.0, view_dep_reg=1e-3)
    jb = {k: _j(v) for k, v in b.items()}

    def jloss(p):
        out = jnet.apply({"params": p}, jb, rng=None, train=True, aux=_j(occ))
        return jnet.loss(out, jb)[0] + jnet.param_loss(p), out

    (jl, jo), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    tb = {k: _t(v) for k, v in b.items()}
    out = net(tb, generator=None, train=True)
    for k in ("rgb", "acc", "depth"):
        _close(out[k], jo[k], what=k)
    loss = net.loss(out, tb)[0] + net.param_loss()
    _close(net.param_loss(), jnet.param_loss(params), rtol=1e-5, atol=0)
    _close(loss, jl, rtol=1e-5, atol=0)
    loss.backward()
    _leaves_close({k: p.grad for k, p in net.named_parameters()}, state_dict_from_jax(jg))


def test_empty_grid_renders_background(kilo):
    params, _, b = kilo
    net = _tnet(params, np.zeros((8, 8, 8), bool), n_keep=8, march="pooled")
    out = net({k: _t(v) for k, v in b.items()})
    _close(out["rgb"], np.ones((32, 3)), rtol=0, atol=1e-6)
    _close(out["acc"], np.zeros(32), rtol=0, atol=1e-6)


def test_renderer_cull_is_output_identical():
    """``render_rays_chunked(active_fn=kilonerf_strip_active)`` equals the
    unculled render (chunk a multiple of the strip and not) and JAX's culled
    render with the same weights, and a fully culled frame is all background
    with every key."""
    from xrnerf_tpu.core.renderer import render_rays_chunked as jrender_rays

    rays, occ = _blob_bundle()
    net = _tnet(None, occ, n_keep=8, march="pooled", hidden=8, n_hidden_layers=1, multires=2, capacity_factor=64.0)
    torch.manual_seed(0)
    net.reset_parameters(torch.Generator().manual_seed(0))
    keys = ("rgb", "disp", "acc")

    def active(strip):
        return lambda r: tkilo.kilonerf_strip_active(r["rays_o"], r["rays_d"], r["near"], r["far"], net.occ_dist,
                                                     DMIN, DMAX, strip=strip, n_probes=48)

    base = render_rays_chunked(net, rays, chunk=32, keys=keys)
    assert base["acc"][:32].max() > 0.01 and base["acc"][32:].max() == 0
    for chunk, strip in ((32, 8), (24, 16)):
        culled = render_rays_chunked(net, rays, chunk=chunk, keys=keys, active_fn=active(strip))
        for k in keys:
            _equal(culled[k], base[k], f"{k} chunk {chunk}")
    jnet = _jnet(n_keep=8, march="pooled", hidden=8, n_hidden_layers=1, multires=2, capacity_factor=64.0)
    params = jax_params_from_state_dict(net.state_dict())
    aux = jkilo.prepare_march_aux(_j(occ))
    want = jrender_rays(
        lambda p, b, r: jnet.apply({"params": p}, b, rng=None, train=False, aux=aux), params, rays, chunk=32,
        keys=keys, active_fn=lambda b: jkilo.kilonerf_strip_active(b["rays_o"], b["rays_d"], b["near"], b["far"],
                                                                   aux.dist, _j(np.float32(DMIN)),
                                                                   _j(np.float32(DMAX)), strip=8, n_probes=48))
    culled = render_rays_chunked(net, rays, chunk=32, keys=keys, active_fn=active(8))
    for k in ("rgb", "acc"):
        _close(culled[k], want[k], what=k)
    _close(culled["disp"], want["disp"], rtol=1e-5, atol=0, what="disp")
    empty = render_rays_chunked(net, rays, chunk=32, keys=keys, active_fn=lambda r: torch.zeros(64, dtype=torch.bool))
    assert set(empty) == set(keys) and empty["rgb"].shape == base["rgb"].shape
    assert (empty["rgb"] == 1).all() and (empty["acc"] == 0).all() and (empty["disp"] == 1e10).all()


# --- StudentNerfNetwork, build_occupancy_grid, datasets ---


def test_student_network_matches_jax():
    kw = dict(resolution=(2, 2, 2), hidden=16, multires=4, multires_dirs=0, capacity_factor=8.0)
    rng = np.random.RandomState(6)
    batch = {"pts": rng.uniform(-1, 1, (256, 3)).astype(np.float32),
             "dirs": rng.randn(256, 3).astype(np.float32),
             "target_rgb": rng.rand(256, 3).astype(np.float32), "target_sigma": rng.rand(256).astype(np.float32)}
    jnet = jkilo.StudentNerfNetwork(**kw)
    jb = {k: _j(v) for k, v in batch.items()}
    params = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(2), jb)["params"])
    net = tkilo.StudentNerfNetwork(**kw)
    net.load_state_dict({k: _t(v) for k, v in state_dict_from_jax(params).items()})
    want = jnet.apply({"params": params}, jb)
    tb = {k: _t(v) for k, v in batch.items()}
    got = net(tb)
    for k in ("rgb", "sigma"):
        _close(got[k], want[k], what=k)
    jl, jlogs = jnet.loss(want, jb)
    tl, tlogs = net.loss(got, tb)
    for k in jlogs:
        _close(tlogs[k], jlogs[k], rtol=1e-5, atol=0, what=k)


@pytest.mark.parametrize("res,sub", [((8, 8, 8), 2), ((12, 8, 16), 3)])
def test_build_occupancy_grid_matches_jax(res, sub):
    def jdensity(p):
        return jnp.where(jnp.linalg.norm(p - jnp.asarray([0.1, -0.2, 0.05]), axis=-1) < 0.5, 100.0, 0.0)

    def tdensity(p):
        c = torch.tensor([0.1, -0.2, 0.05], dtype=p.dtype)
        return torch.where(torch.linalg.norm(p - c, dim=-1) < 0.5, 100.0, 0.0)

    want = jkilo.build_occupancy_grid(jdensity, (-0.7,) * 3, (0.7,) * 3, res=res, subsamples=sub, threshold=10.0)
    got = tkilo.build_occupancy_grid(tdensity, (-0.7,) * 3, (0.7,) * 3, res=res, subsamples=sub, threshold=10.0,
                                     device="cpu")
    assert got.shape == tuple(res) and got.dtype == bool
    _equal(got, want)
    assert 0.02 < got.mean() < 0.6


def test_kilonerf_datasets_match_jax(synthetic_scene):
    from xrnerf_tpu.datasets.kilonerf import KiloNerfDataset as JDs
    from xrnerf_tpu.datasets.kilonerf import KiloNerfDistillDataset as JDistill

    from xrnerf_torch.datasets.kilonerf import KiloNerfDataset, KiloNerfDistillDataset

    kw = dict(datadir=synthetic_scene, N_rand=64, testskip=1, global_domain_min=(-0.7,) * 3)
    jds, ds = JDs(**kw), KiloNerfDataset(**kw)
    _close(ds.global_domain_min, jds.global_domain_min, rtol=0, atol=0)
    _close(ds.global_domain_max, jds.global_domain_max, rtol=0, atol=0)
    for k, v in jds.train_batch(3).items():
        _equal(ds.train_batch(3)[k], v, k)

    def jteacher(p, d):
        return 0.5 + 0.5 * jnp.tanh(p), 5.0 * jnp.exp(-4.0 * jnp.sum(p**2, -1)) + 0 * d[:, 0]

    def tteacher(p, d):
        return 0.5 + 0.5 * torch.tanh(p), 5.0 * torch.exp(-4.0 * torch.sum(p**2, -1)) + 0 * d[:, 0]

    jd = JDistill(resolution=(2, 3, 2), points_per_net=8, teacher_fn=jteacher, seed=4)
    td = KiloNerfDistillDataset(resolution=(2, 3, 2), points_per_net=8, teacher_fn=tteacher, seed=4, device="cpu")
    assert td.N_rand == jd.N_rand == 96
    for step in (0, 5):
        want, got = jd.train_batch(step), td.train_batch(step)
        for k in ("pts", "dirs"):
            _equal(got[k], want[k], k)
        for k in ("target_rgb", "target_sigma"):
            _close(got[k], want[k], what=k)


# --- the trainer, checkpoints and the CLI ---


class _Losses:
    def __init__(self):
        self.losses = []

    def on_run_begin(self, tr): ...

    def on_eval(self, tr, step): ...

    def on_run_end(self, tr): ...

    def after_step(self, tr, step, logs):
        self.losses.append(float(np.asarray(logs["loss"])))


class _Deterministic(tkilo.KiloNerfNetwork):
    """Trains without jitter whatever generator it is given."""

    def forward(self, batch, generator=None, train=False):
        return super().forward(batch, None, train)


def _finetune_kw(occ_path):
    return dict(resolution=(4, 4, 4), domain_min=(-0.7,) * 3, domain_max=(0.7,) * 3, hidden=16, multires=4,
                multires_dirs=2, n_samples=32, n_keep=12, march="pooled", march_group=8, march_groups_keep=4,
                capacity_factor=1.25, view_dep_reg=1e-3, occupancy_path=str(occ_path))


def _occupancy_file(tmp_path):
    occ = np.zeros((16, 16, 16), bool)
    occ[4:12, 4:12, 4:12] = True
    path = tmp_path / "occupancy.npy"
    np.save(path, occ)
    return path


def test_trainer_matches_jax_trainer(synthetic_scene, tmp_path):
    """Four steps of each trainer from the same weights on the same batches:
    the grid from ``occupancy_path`` as aux, ``param_loss`` in the loss, the
    config's Adam; then the eval renders through the grid agree."""
    from xrnerf_tpu.core.renderer import render_image as jrender
    from xrnerf_tpu.core.trainer import Trainer as JTrainer
    from xrnerf_tpu.datasets.kilonerf import KiloNerfDataset as JDs

    from xrnerf_torch.datasets.kilonerf import KiloNerfDataset

    class JDeterministic(jkilo.KiloNerfNetwork):
        def __call__(self, batch, rng=None, train=False, aux=None):
            return super().__call__(batch, rng=None, train=train, aux=aux)

    kw = _finetune_kw(_occupancy_file(tmp_path))
    dkw = dict(datadir=synthetic_scene, N_rand=64, testskip=1)
    opt = dict(type="adam", lr=1e-3, lr_decay_steps=500000, lr_decay_rate=0.1)
    jrec, rec = _Losses(), _Losses()
    jtr = JTrainer(JDeterministic(**kw), JDs(**dkw), optimizer=opt, work_dir=str(tmp_path / "jax"), max_iters=4,
                   ckpt_interval=0, log_interval=2, hooks=[jrec])
    p0 = jax.tree_util.tree_map(np.asarray, jtr.state.params)
    tr = Trainer(_Deterministic(**kw), KiloNerfDataset(**dkw), optimizer=opt, work_dir=str(tmp_path / "torch"),
                 max_iters=4, ckpt_interval=0, log_interval=2, hooks=[rec], device="cpu")
    assert tr.network.occupancy is not None and bool(tr.network.occupancy.any())
    tr.network.load_state_dict({k: _t(v) for k, v in state_dict_from_jax(p0).items()})
    jtr.run()
    tr.run()
    np.testing.assert_allclose(rec.losses, jrec.losses, rtol=1e-5)
    assert "param_reg" in tr.last_logs and tr.last_logs["param_reg"] > 0
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtr.state.params))
    for k, p in tr.network.mlp.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want["mlp." + k], rtol=0, atol=5e-6, err_msg=k)
    rays, gt = tr.dataset.eval_item(int(tr.dataset.i_test[0]))
    got = tr.render_image(rays, gt.shape[0], gt.shape[1])
    want_img = jrender(jtr._eval_apply, (jtr.eval_params, jtr.aux), rays, gt.shape[0], gt.shape[1], chunk=8192)
    for k in ("rgb", "acc"):
        _close(got[k], want_img[k], what=k)


def test_checkpoint_and_weights_carry_the_grid(synthetic_scene, tmp_path):
    """A resumed trainer takes the checkpoint's grid (not its own file's);
    ``load_from`` a weights file with a grid takes it, one without keeps the
    network's."""
    from xrnerf_torch.datasets.kilonerf import KiloNerfDataset

    kw = _finetune_kw(_occupancy_file(tmp_path))
    ds = KiloNerfDataset(datadir=synthetic_scene, N_rand=32, testskip=1)
    tr = Trainer(tkilo.KiloNerfNetwork(**kw), ds, work_dir=str(tmp_path / "a"), max_iters=2, ckpt_interval=2,
                 log_interval=1, device="cpu")
    other = np.random.RandomState(0).rand(16, 16, 16) < 0.5
    tr.network.set_occupancy(other)
    tr.run()
    ckpt = str(tmp_path / "a" / "ckpt_2.pt")
    res = Trainer(tkilo.KiloNerfNetwork(**kw), ds, work_dir=str(tmp_path / "b"), max_iters=3, ckpt_interval=0,
                  log_interval=1, resume_from=ckpt, device="cpu")
    assert res.start_step == 2
    _equal(res.network.occupancy, other)
    _equal(res.network.occ_dist, tkilo.distance_transform_linf(_t(other)))
    assert res.run() == 3
    pt = tmp_path / "w.pt"
    torch.save(tr.network.state_dict(), pt)
    srv = Trainer(tkilo.KiloNerfNetwork(**kw), ds, work_dir=None, load_from=str(pt), device="cpu")
    _equal(srv.network.occupancy, other)
    torch.save(tr.network.mlp.state_dict(), pt)  # weights only, no grid
    bare = tkilo.KiloNerfNetwork(**kw)
    bare.init_aux()
    bare.mlp.load_state_dict(torch.load(pt, weights_only=True))
    bare.load_state_dict({"mlp." + k: v for k, v in torch.load(pt, weights_only=True).items()})
    _equal(bare.occupancy, np.load(kw["occupancy_path"]))


def test_cli_trains_a_cut_of_the_finetune_config(synthetic_scene, tmp_path):
    """``run_nerf`` trains ``configs/kilonerf/kilonerf_finetune.py`` with the
    network narrowed, then ``--test_only --load_from`` in a subprocess gives
    the same test PSNR."""
    src = open(os.path.join(ROOT, "configs", "kilonerf", "kilonerf_finetune.py")).read()
    occ = _occupancy_file(tmp_path)
    cfg = tmp_path / "kilo_cfg.py"
    cfg.write_text(src + f"""
model.update(resolution=(4, 4, 4), hidden=16, multires=4, multires_dirs=2, n_samples=32, eval_budget=2048,
             occupancy_path=r"{occ}")
data.update(datadir=r"{synthetic_scene}", N_rand=64, testskip=2)
hooks = [dict(type="TestHook", save_img=False)]
eval_chunk = 256
log_interval = 2
""")
    wd = tmp_path / "wd"
    tr = run_nerf.main(["--config", str(cfg), "--device", "cpu", "--max_iters", "4", "--work_dir", str(wd)])
    assert tr.step == 4 and isinstance(tr.network, tkilo.KiloNerfNetwork) and np.isfinite(tr.last_logs["loss"])
    assert tr.network.march == "pooled" and tr.network.mlp.capacity_factor == 1.25
    res = json.load(open(wd / "test" / "test_results.json"))
    pt = tmp_path / "w.pt"
    torch.save(tr.network.state_dict(), pt)
    out = subprocess.run(
        [sys.executable, "-m", "xrnerf_torch.run_nerf", "--config", str(cfg), "--device", "cpu", "--test_only",
         "--load_from", str(pt), "--work_dir", str(tmp_path / "test_only")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    res2 = json.load(open(tmp_path / "test_only" / "test" / "test_results.json"))
    assert res2["psnr"] == pytest.approx(res["psnr"], abs=1e-4)
