"""The Mip-NeRF slice of the PyTorch port, held against the JAX package on the
same numpy inputs: every function of ``models/embedders/mip.py`` (both
covariance forms), the searchsorted inverse CDF against the broadcast-mask
one, ``mip_volume_render``, ``MipNerfNetwork`` (eval outputs, loss, and the
loss's gradients per leaf with bridged weights), ``MipMultiScaleDataset``,
``Trainer.run`` under the mip schedule with ``grad_clip``, and the CLI on
``configs/mipnerf/mipnerf_multiscale.py`` cut to a tiny network.

Tolerances. Both sides are f32: forwards rtol 1e-4 / atol 1e-5 unless a
test says otherwise; gradients per leaf cosine > 0.999 and norm ratio
within 1e-3 of 1. The resampled level's outputs, where last-ulp cdf
differences can move a sample, are held by ``_close_fine`` (max / mean /
share of values), as the vanilla network's fine pass is.
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

import xrnerf_tpu.models.embedders.mip as jmip  # noqa: E402
import xrnerf_torch.models.embedders.mip as tmip  # noqa: E402
from xrnerf_torch import build_dataset, build_network, run_nerf  # noqa: E402
from xrnerf_torch.core.trainer import Trainer  # noqa: E402
from xrnerf_torch.models.networks.mipnerf import MipNerfNetwork  # noqa: E402
from xrnerf_torch.models.renders.volume import mip_volume_render  # noqa: E402
from xrnerf_torch.utils.weights import jax_params_from_state_dict, state_dict_from_jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
NET_KW = dict(num_levels=2, n_samples=16, netdepth=8, netwidth=64)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _close_fine(got, want, atol, what):
    """Outputs of a resampled level. Its samples come from the inverse cdf,
    where t = (u - cdf_g0) / (cdf_g1 - cdf_g0) divides by a bin's mass: a
    last-ulp cdf difference (XLA sums in another order) moves a sample in a
    light bin. Bounds as ``tests/test_torch_nerf_render.py:_close_fine``: at
    most 5 % of values above ``atol``, none above 20x, mean within
    ``atol``."""
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert err.max() <= 20 * atol, f"{what}: max abs err {err.max()}"
    assert err.mean() <= atol, f"{what}: mean abs err {err.mean()}"
    share = float((err > atol).mean())
    assert share <= 0.05, f"{what}: {share:.1%} of values above atol {atol}"


def _cos(a, b):
    a, b = np.ravel(np.asarray(a, np.float64)), np.ravel(np.asarray(b, np.float64))
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _rays(n, seed, radii=True):
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    b = {
        "rays_o": (0.3 * rng.randn(n, 3)).astype(np.float32),
        "rays_d": (d * rng.uniform(0.8, 1.2, (n, 1))).astype(np.float32),
        "near": np.full((n, 1), 2.0, np.float32),
        "far": np.full((n, 1), 6.0, np.float32),
        "target": rng.rand(n, 3).astype(np.float32),
        "lossmult": (4.0 ** rng.randint(0, 4, (n, 1))).astype(np.float32),
    }
    if radii:
        b["radii"] = (rng.uniform(5e-4, 3e-3, (n, 1))).astype(np.float32)
    return b


def _edges(n, s, seed):
    """Sorted interval edges [n, s+1] in [2, 6]."""
    rng = np.random.RandomState(seed)
    return np.sort(rng.uniform(2.0, 6.0, (n, s + 1)), axis=-1).astype(np.float32)


# --- embedders/mip.py, function by function ---


@pytest.mark.parametrize("diag", [True, False], ids=["diag", "full"])
def test_lift_gaussian(diag):
    rng = np.random.RandomState(0)
    d = rng.randn(32, 3).astype(np.float32)
    t_mean, t_var, r_var = (rng.uniform(0.1, 4.0, (32, 8)).astype(np.float32) for _ in range(3))
    want = jmip.lift_gaussian(jnp.asarray(d), t_mean, t_var, r_var, diag)
    got = tmip.lift_gaussian(_t(d), _t(t_mean), _t(t_var), _t(r_var), diag)
    for g, w, k in zip(got, want, ("mean", "cov")):
        assert g.shape == w.shape, k
        _close(g, w, what=k)


@pytest.mark.parametrize("stable", [True, False], ids=["stable", "plain"])
@pytest.mark.parametrize("diag", [True, False], ids=["diag", "full"])
def test_conical_frustum_to_gaussian(stable, diag):
    """The plain form subtracts the squared mean from the second moment, which
    cancels to nothing in f32 for narrow frusta (that is why the stable form
    exists); it is held on wide ones, t1 - t0 in [1, 2]."""
    rng = np.random.RandomState(1)
    d = rng.randn(16, 3).astype(np.float32)
    if stable:
        t = _edges(16, 12, seed=2)
        t0, t1 = t[:, :-1], t[:, 1:]
    else:
        t0 = rng.uniform(0.5, 1.0, (16, 12)).astype(np.float32)
        t1 = (t0 + rng.uniform(1.0, 2.0, (16, 12))).astype(np.float32)
    radius = rng.uniform(5e-4, 3e-3, (16, 1)).astype(np.float32)
    want = jmip.conical_frustum_to_gaussian(jnp.asarray(d), t0, t1, radius, diag, stable)
    got = tmip.conical_frustum_to_gaussian(_t(d), _t(t0), _t(t1), _t(radius), diag, stable)
    for g, w, k in zip(got, want, ("mean", "cov")):
        _close(g, w, what=k)


@pytest.mark.parametrize("diag", [True, False], ids=["diag", "full"])
def test_cylinder_to_gaussian(diag):
    rng = np.random.RandomState(3)
    d = rng.randn(16, 3).astype(np.float32)
    t = _edges(16, 12, seed=4)
    radius = rng.uniform(5e-4, 3e-3, (16, 1)).astype(np.float32)
    want = jmip.cylinder_to_gaussian(jnp.asarray(d), t[:, :-1], t[:, 1:], radius, diag)
    got = tmip.cylinder_to_gaussian(_t(d), _t(t[:, :-1]), _t(t[:, 1:]), _t(radius), diag)
    for g, w, k in zip(got, want, ("mean", "cov")):
        _close(g, w, what=k)


@pytest.mark.parametrize("shape", ["cone", "cylinder"])
@pytest.mark.parametrize("diag", [True, False], ids=["diag", "full"])
def test_cast_rays(shape, diag):
    b = _rays(16, seed=5)
    t = _edges(16, 12, seed=6)
    want = jmip.cast_rays(t, b["rays_o"], b["rays_d"], b["radii"], shape, diag)
    got = tmip.cast_rays(_t(t), _t(b["rays_o"]), _t(b["rays_d"]), _t(b["radii"]), shape, diag)
    for g, w, k in zip(got, want, ("means", "covs")):
        assert g.shape == w.shape
        _close(g, w, what=k)
    with pytest.raises(ValueError):
        tmip.cast_rays(_t(t), _t(b["rays_o"]), _t(b["rays_d"]), _t(b["radii"]), "sphere")


def _truth_close(got, truth, bound, what):
    """|got - truth| <= bound (elementwise), naming the worst element."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    err = np.abs(got.astype(np.float64) - truth)
    excess = err - bound
    i = np.unravel_index(int(np.argmax(excess)), err.shape)
    assert excess[i] <= 0, (
        f"{what}: {int((excess > 0).sum())} of {err.size} values past the bound; worst at {i}: "
        f"got {got[i]!r}, float64 truth {truth[i]!r}, error {err[i]:.3g} > bound {np.broadcast_to(bound, err.shape)[i]:.3g}"
    )


# The f32 error a correct implementation of exp(-v/2) sin(x) and of its
# variance can reach: both are O(1) results of about eight f32 roundings and
# two transcendentals accurate to 1 ulp, so 8 ulp of 1.0 (2^-23 each). Both
# packages sit within 2.2e-7 of the float64 truth on the inputs below.
F32_TRUTH_ATOL = 8 * 2.0**-23


def test_expected_sin():
    """Each package against a float64 numpy truth on the same f32 inputs, at
    the bound f32 arithmetic justifies, then against each other at the sum of
    the two bounds. A failure names the side that is off and the element."""
    rng = np.random.RandomState(7)
    x = rng.uniform(-20, 20, 4096).astype(np.float32)
    v = np.exp(rng.uniform(-12, 3, 4096)).astype(np.float32)
    x64, v64 = x.astype(np.float64), v.astype(np.float64)
    mean = np.exp(-0.5 * v64) * np.sin(x64)
    var = np.maximum(0.5 * (1 - np.exp(-2 * v64) * np.cos(2 * x64)) - mean**2, 0)
    want = jmip.expected_sin(jnp.asarray(x), jnp.asarray(v))
    got = tmip.expected_sin(_t(x), _t(v))
    for g, w, truth, k in zip(got, want, (mean, var), ("mean", "variance")):
        _truth_close(w, truth, F32_TRUTH_ATOL, f"JAX {k}")
        _truth_close(g, truth, F32_TRUTH_ATOL, f"torch {k}")
        _close(g, w, rtol=0, atol=2 * F32_TRUTH_ATOL, what=k)


@pytest.mark.parametrize("diag", [True, False], ids=["diag", "full"])
def test_integrated_pos_enc(diag):
    """Degrees 0-16 on the Gaussians of real frusta (means up to ~6, so
    ``sin`` sees arguments up to ~2e5 at degree 15), held as
    ``test_expected_sin`` is: each package against a float64 truth, then
    against each other. The truth takes the mean and variance from the f32
    Gaussians (scaling by 2^k and 4^k is exact) and is exp(-var/2) times sin
    and cos of the mean. Both packages take the cosine as the sine of the f32
    sum ``y + pi/2``, which is off the true argument by up to half an f32
    ulp of ``|y| + 2``: that, times the damping, is added to the bound of the
    cosine half, and both packages share it, so it cancels between them."""
    b = _rays(64, seed=8)
    t = _edges(64, 16, seed=9)
    mc = jmip.cast_rays(t, b["rays_o"], b["rays_d"], b["radii"], "cone", diag)
    mc = tuple(np.asarray(a).reshape(64 * 16, *a.shape[2:]) for a in mc)
    want = jmip.integrated_pos_enc(tuple(jnp.asarray(a) for a in mc), 0, 16, diag)
    got = tmip.integrated_pos_enc(tuple(_t(a) for a in mc), 0, 16, diag)
    assert got.shape == want.shape == (64 * 16, 96)

    means = mc[0].astype(np.float64)
    var = (mc[1] if diag else np.diagonal(mc[1], axis1=-2, axis2=-1)).astype(np.float64)
    scales = 2.0 ** np.arange(16)
    y = (means[:, None, :] * scales[:, None]).reshape(len(means), -1)
    damp = np.exp(-0.5 * (var[:, None, :] * scales[:, None] ** 2).reshape(len(means), -1))
    truth = np.concatenate([damp * np.sin(y), damp * np.cos(y)], -1)
    shift = 0.5 * np.spacing(np.abs(y).astype(np.float32) + np.float32(2)).astype(np.float64) * damp
    bound = F32_TRUTH_ATOL + np.concatenate([np.zeros_like(shift), shift], -1)
    _truth_close(want, truth, bound, "JAX IPE")
    _truth_close(got, truth, bound, "torch IPE")
    _close(got, want, rtol=0, atol=2 * F32_TRUTH_ATOL, what="IPE")


@pytest.mark.parametrize("identity", [True, False])
def test_pos_enc(identity):
    x = np.random.RandomState(10).randn(128, 3).astype(np.float32)
    want = jmip.pos_enc(jnp.asarray(x), 0, 4, identity)
    got = tmip.pos_enc(_t(x), 0, 4, identity)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("lindisp", [False, True])
def test_sample_along_rays_mip(lindisp):
    b = _rays(32, seed=11)
    args = (b["rays_o"], b["rays_d"], b["radii"], 16, b["near"], b["far"])
    want_t, (want_m, want_c) = jmip.sample_along_rays_mip(None, *map(jnp.asarray, args[:3]), 16, b["near"], b["far"],
                                                          False, lindisp)
    got_t, (got_m, got_c) = tmip.sample_along_rays_mip(None, *map(_t, args[:3]), 16, _t(b["near"]), _t(b["far"]),
                                                       False, lindisp)
    for g, w, k in ((got_t, want_t, "t"), (got_m, want_m, "means"), (got_c, want_c, "covs")):
        _close(g, w, what=k)


def test_sample_along_rays_mip_randomized_with_shared_draws(monkeypatch):
    """The randomized draw: JAX given torch's uniforms gives the same edges."""
    b = _rays(32, seed=12)
    gen_draws = torch.rand((32, 17), generator=torch.Generator().manual_seed(3))
    monkeypatch.setattr(jmip.jax.random, "uniform", lambda key, shape, dtype=None: jnp.asarray(gen_draws.numpy()))
    want_t, _ = jmip.sample_along_rays_mip(jax.random.PRNGKey(0), *map(jnp.asarray, (b["rays_o"], b["rays_d"],
                                           b["radii"])), 16, b["near"], b["far"], True, False)
    got_t, _ = tmip.sample_along_rays_mip(torch.Generator().manual_seed(3), *map(_t, (b["rays_o"], b["rays_d"],
                                          b["radii"])), 16, _t(b["near"]), _t(b["far"]), True, False)
    _close(got_t, want_t)
    assert bool((got_t[:, 1:] >= got_t[:, :-1]).all())


def _broadcast_pdf_indices(cdf, u):
    """The JAX package's bracket (``mip.py:184-192``): max / min over the
    dense [N, B+1, S] mask, in torch, as edge values of ``x``."""
    mask = u[..., None, :] >= cdf[..., :, None]

    def find(x):
        x0 = torch.max(torch.where(mask, x[..., None], x[..., :1, None]), dim=-2).values
        x1 = torch.min(torch.where(~mask, x[..., None], x[..., -1:, None]), dim=-2).values
        return x0, x1

    return find


def _weights_cases():
    rng = np.random.RandomState(13)
    w = rng.rand(24, 16).astype(np.float32)
    # cdf reaches 1 before its last bin: dyadic masses, so every partial sum
    # is exact on both sides and the cdf holds exact 1s from edge r + 4 on
    for r in range(6):
        w[r] = 0.0
        w[r, r : r + 4] = (1.0, 1.0, 2.0, 4.0)
    w[6:9] = 0.0  # an empty histogram: the padding takes over
    w[9:12, :3] = 0.0  # leading empty bins: repeated zeros in the cdf
    w[12:15] *= 1e-7  # sums below the 1e-5 padding floor
    return w


def test_pdf_searchsorted_matches_broadcast_mask():
    """The port's bracket (searchsorted, side right) picks the same edges as
    the JAX package's broadcast mask, for u on the linspace and at random,
    including cdfs that reach 1 early and hold repeated values."""
    w = torch.from_numpy(_weights_cases())
    bins = torch.from_numpy(_edges(24, 16, seed=14))
    weight_sum = w.sum(-1, keepdim=True)
    padding = torch.clamp(1e-5 - weight_sum, min=0)
    pdf = (w + padding / 16) / (weight_sum + padding)
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], -1), max=1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf, torch.ones_like(cdf[:, :1])], -1)
    assert all(bool((cdf[r, r + 4 :] == 1).all()) and cdf[r, r + 3] < 1 for r in range(6))
    eps = float(torch.finfo(torch.float32).eps)
    u_lin = torch.linspace(0, 1 - eps, 33).expand(24, 33).contiguous()
    u_rand = torch.clamp(torch.rand((24, 64), generator=torch.Generator().manual_seed(0)), max=1 - eps)
    u_hits = torch.gather(cdf, -1, torch.randint(0, 16, (24, 8), generator=torch.Generator().manual_seed(1)))
    for u in (u_lin, u_rand, torch.clamp(u_hits, max=1 - eps)):
        find = _broadcast_pdf_indices(cdf, u)
        i = torch.searchsorted(cdf, u, right=True)
        below, above = torch.clamp(i - 1, min=0), torch.clamp(i, max=16)
        for x in (bins, cdf):
            x0, x1 = find(x)
            assert torch.equal(torch.gather(x, -1, below), x0)
            assert torch.equal(torch.gather(x, -1, above), x1)


def test_sorted_piecewise_constant_pdf_matches_jax():
    w = _weights_cases()
    bins = _edges(24, 16, seed=15)
    want = jmip.sorted_piecewise_constant_pdf(None, jnp.asarray(bins), jnp.asarray(w), 17, False)
    got = tmip.sorted_piecewise_constant_pdf(None, _t(bins), _t(w), 17, False)
    _close(got, want)


def test_sorted_piecewise_constant_pdf_randomized_with_shared_draws(monkeypatch):
    w = _weights_cases()
    bins = _edges(24, 16, seed=16)
    draws = torch.rand((24, 32), generator=torch.Generator().manual_seed(5))
    monkeypatch.setattr(jmip.jax.random, "uniform",
                        lambda key, shape, dtype=None, maxval=1.0: jnp.asarray(draws.numpy()) * maxval)
    want = jmip.sorted_piecewise_constant_pdf(jax.random.PRNGKey(0), jnp.asarray(bins), jnp.asarray(w), 32, True)
    got = tmip.sorted_piecewise_constant_pdf(torch.Generator().manual_seed(5), _t(bins), _t(w), 32, True)
    _close(got, want)
    assert bool((got >= _t(bins[:, :1])).all() and (got <= _t(bins[:, -1:])).all())


@pytest.mark.parametrize("stop_grad", [True, False])
def test_resample_along_rays(stop_grad):
    b = _rays(32, seed=17)
    t = _edges(32, 16, seed=18)
    w = np.random.RandomState(19).rand(32, 16).astype(np.float32)
    args = (b["rays_o"], b["rays_d"], b["radii"], t, w)
    want = jmip.resample_along_rays(None, *map(jnp.asarray, args), False, "cone", stop_grad)
    tw = _t(w).requires_grad_()
    got = tmip.resample_along_rays(None, *map(_t, args[:4]), tw, False, "cone", stop_grad)
    _close(got[0], want[0], what="t")
    _close(got[1][0], want[1][0], what="means")
    _close(got[1][1], want[1][1], what="covs")
    assert got[0].requires_grad is not stop_grad


# --- renders/volume.py: mip_volume_render ---


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_mip_volume_render(white_bkgd):
    from xrnerf_tpu.models.renders.volume import mip_volume_render as jrender

    rng = np.random.RandomState(20)
    raw_rgb = rng.randn(64, 16, 3).astype(np.float32)
    raw_sigma = (3 * rng.randn(64, 16)).astype(np.float32)
    raw_sigma[:4] = -30.0  # empty rays: acc ~0, distance clamped
    t = _edges(64, 16, seed=21)
    rays_d = rng.randn(64, 3).astype(np.float32)
    want = jrender(raw_rgb, raw_sigma, t, rays_d, white_bkgd, 0.001, -1.0)
    got = mip_volume_render(_t(raw_rgb), _t(raw_sigma), _t(t), _t(rays_d), white_bkgd, 0.001, -1.0)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], what=k)


# --- networks/mipnerf.py ---


def _jax_net(**kw):
    from xrnerf_tpu.models.networks.mipnerf import MipNerfNetwork as JMip

    return JMip(**kw)


def _bridged(seed=0, **kw):
    """(flax module, its params with small random biases, the port's network
    holding the same weights)."""
    kw = dict(NET_KW, **kw)
    jnet = _jax_net(**kw)
    params = jax.jit(lambda k, b: jnet.init(k, b, rng=None, train=False))(jax.random.PRNGKey(seed), _rays(8, 0))
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: (0.05 * rng.randn(*a.shape)).astype(np.float32) if a.ndim == 1 else np.asarray(a),
        params["params"])
    net = build_network(dict(type="MipNerfNetwork", **kw), device="cpu")
    net.load_state_dict({k: _t(v) for k, v in state_dict_from_jax(params).items()})
    return jnet, params, net


@pytest.fixture(scope="module")
def bridged():
    return _bridged()


def test_network_names_match_flax(bridged):
    _, params, net = bridged
    assert set(net.state_dict()) == set(state_dict_from_jax(params))
    assert net.mlp.in_ch == 96 and net.mlp.in_ch_views == 27 and not net.mlp.fused


def test_network_eval_matches_jax(bridged):
    jnet, params, net = bridged
    b = _rays(256, seed=22)
    want = jax.jit(lambda p, bb: jnet.apply({"params": p}, bb, rng=None, train=False))(params, b)
    got = net({k: _t(v) for k, v in b.items()}, train=False)
    assert sorted(got) == sorted(want) == ["acc", "distance", "level0_rgb", "rgb"]
    assert not got["rgb"].requires_grad
    _close(got["level0_rgb"], want["level0_rgb"], what="level0_rgb")
    for k, tol in (("rgb", ATOL), ("acc", ATOL), ("distance", 10 * ATOL)):  # distance: t in [2, 6]
        _close_fine(got[k].numpy(), want[k], tol, k)


def test_network_default_radii_and_no_viewdirs():
    jnet, params, net = _bridged(seed=1, use_viewdirs=False, num_levels=3, n_samples=8)
    b = _rays(64, seed=23, radii=False)
    want = jax.jit(lambda p, bb: jnet.apply({"params": p}, bb, rng=None, train=False))(params, b)
    got = net({k: _t(v) for k, v in b.items()}, train=False)
    assert sorted(got) == sorted(want) == ["acc", "distance", "level0_rgb", "level1_rgb", "rgb"]
    _close(got["level0_rgb"], want["level0_rgb"])
    for k in ("level1_rgb", "rgb", "acc"):
        _close_fine(got[k].numpy(), want[k], ATOL, k)


def test_network_loss_matches_jax(bridged):
    jnet, params, net = bridged
    b = _rays(128, seed=24)
    out = jax.jit(lambda p, bb: jnet.apply({"params": p}, bb, rng=None, train=False))(params, b)
    want_loss, want_log = jnet.loss(out, b)
    tout = {k: _t(np.asarray(v)) for k, v in out.items()}
    got_loss, got_log = net.loss(tout, {k: _t(v) for k, v in b.items()})
    assert sorted(got_log) == sorted(want_log) == ["level0_mse", "loss", "mse", "psnr"]
    for k in want_log:
        _close(got_log[k], want_log[k], rtol=1e-5, atol=0, what=k)
    nolm = {k: v for k, v in b.items() if k != "lossmult"}
    _close(net.loss(tout, {k: _t(v) for k, v in nolm.items()})[0], jnet.loss(out, nolm)[0], rtol=1e-5, atol=0)


def test_network_loss_gradients_match_jax(bridged):
    """The deterministic training path (``generator=None``, JAX ``rng=None``):
    loss and per-leaf gradients through both levels."""
    jnet, params, net = bridged
    b = _rays(128, seed=25)

    def jloss(p):
        return jnet.loss(jnet.apply({"params": p}, b, rng=None, train=True), b)[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    net.zero_grad(set_to_none=True)
    tb = {k: _t(v) for k, v in b.items()}
    out = net(tb, generator=None, train=True)
    assert out["rgb"].requires_grad
    loss, _ = net.loss(out, tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    got = jax_params_from_state_dict({k: p.grad.numpy() for k, p in net.named_parameters()})
    leaves = jax.tree_util.tree_leaves_with_path(jg)
    assert len(leaves) == 24
    for (path, w), (_, g) in zip(leaves, jax.tree_util.tree_leaves_with_path(got)):
        name = jax.tree_util.keystr(path)
        assert _cos(g, w) > 0.999, f"{name}: cos {_cos(g, w)}"
        ratio = float(np.linalg.norm(g) / np.linalg.norm(w))
        assert abs(ratio - 1) < 1e-3, f"{name}: norm ratio {ratio}"


def test_train_mode_draws_from_generator(bridged):
    """With a generator the draws (jitter, resampling, density noise) vary by
    seed and repeat for the same seed; without one training is deterministic."""
    _, _, net = bridged
    noisy = MipNerfNetwork(**NET_KW, density_noise=1.0)
    noisy.load_state_dict(net.state_dict())
    tb = {k: _t(v) for k, v in _rays(32, seed=26).items()}
    a = noisy(tb, generator=torch.Generator().manual_seed(0), train=True)["rgb"]
    b = noisy(tb, generator=torch.Generator().manual_seed(0), train=True)["rgb"]
    c = noisy(tb, generator=torch.Generator().manual_seed(1), train=True)["rgb"]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(net(tb, None, train=True)["rgb"], net(tb, None, train=True)["rgb"])


# --- datasets/multiscale.py ---


@pytest.fixture(scope="module")
def datasets(synthetic_scene):
    from xrnerf_tpu.datasets.multiscale import MipMultiScaleDataset as JMs

    kw = dict(datadir=synthetic_scene, n_scales=4, N_rand=64, testskip=1, white_bkgd=True)
    return JMs(**kw), build_dataset(dict(type="MipMultiScaleDataset", **kw))


def test_multiscale_dataset_matches_jax(datasets):
    jds, ds = datasets
    assert ds.scales == jds.scales and [s["H"] for s in ds.scales] == [24, 12, 6, 3]
    assert [s["lossmult"] for s in ds.scales] == [1.0, 4.0, 16.0, 64.0]
    np.testing.assert_array_equal(ds.i_val, jds.i_val)
    np.testing.assert_array_equal(ds.i_test, jds.i_test)
    for a, b in zip(ds._imgs_by_scale, jds._imgs_by_scale):
        _close(a, b, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ds._perm, jds._perm)
    # targets of the downscaled images: area means summed in another order
    # than OpenCV's float path (1.2e-7 on the CPU); everything else exact
    _close(ds._pool["target"], jds._pool["target"], rtol=0, atol=1e-6)
    for k in jds._pool:
        if k != "target":
            np.testing.assert_array_equal(ds._pool[k], jds._pool[k], err_msg=k)
    for step, host, hosts in ((0, 0, 1), (7, 1, 2), (10_000, 0, 1)):
        got, want = ds.train_batch(step, host, hosts), jds.train_batch(step, host, hosts)
        assert sorted(got) == sorted(want) == ["far", "lossmult", "near", "radii", "rays_d", "rays_o", "target"]
        _close(got["target"], want["target"], rtol=0, atol=1e-6)
        for k in want:
            if k != "target":
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_multiscale_eval_items_match_jax(datasets):
    jds, ds = datasets
    for item in list(ds.i_val[:4]) + list(ds.i_test[-4:]):
        (rays, gt), (jrays, jgt) = ds.eval_item(int(item)), jds.eval_item(int(item))
        assert gt.shape[0] == 24 // 2 ** (item % 4)
        _close(gt, jgt, rtol=0, atol=1e-6)
        for k in jrays:
            np.testing.assert_array_equal(rays[k], jrays[k], err_msg=k)
    pose = ds.render_poses[3]
    (rays, hw), (jrays, jhw) = ds.spiral_item(pose), jds.spiral_item(pose)
    assert hw == jhw == (24, 24)
    for k in jrays:
        np.testing.assert_array_equal(rays[k], jrays[k], err_msg=k)


@pytest.mark.parametrize("hw", [(3, 3), (6, 6), (10, 7), (12, 12), (24, 24)])
def test_ssim_matches_jax_at_every_scale(hw):
    """The multiscale test set scores 24x24 scenes at 12, 6 and 3 pixels:
    SSIM with an 11-tap window on an image smaller than the window takes
    the JAX version's 'valid' convolution, where the two trade places."""
    from xrnerf_tpu.utils.metrics import ssim as jssim
    from xrnerf_torch.utils.metrics import ssim

    rng = np.random.RandomState(hw[0] * 100 + hw[1])
    a = rng.rand(*hw, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*hw, 3), 0, 1).astype(np.float32)
    _close(ssim(a, b), jssim(a, b), rtol=1e-5, atol=1e-6)


# --- Trainer.run under the mip schedule, and the CLI ---


class _Deterministic(MipNerfNetwork):
    """Trains on the deterministic path whatever generator it is given."""

    def forward(self, batch, generator=None, train=False):
        return super().forward(batch, None, train)


def test_trainer_run_matches_jax_trainer(datasets, tmp_path):
    """Four steps of each trainer from the same weights on the same batches,
    deterministic path, the mip lr schedule (log-lerp, delayed sine warmup)
    and a global-norm clip that binds at every step. torch's
    ``clip_grad_norm_`` scales by max / (norm + 1e-6), optax by max / norm: a
    relative 1e-6 / norm in the gradient. The clip leaves entries of ~1e-8,
    Adam's eps, where the two libraries' roundings move the normalised
    update most. Measured on the CPU: per-step losses agree to 5.6e-7
    relative; the parameters to 1.8e-6 absolute (the first layer; 3e-8 in
    the heads) after updates of up to 5.5e-4. Bounds: losses rtol 1e-5,
    parameters atol 5e-6, under 1 % of those updates."""
    from xrnerf_tpu.core.trainer import Trainer as JTrainer
    from xrnerf_tpu.models.networks.mipnerf import MipNerfNetwork as JMip

    class JDeterministic(JMip):
        def __call__(self, batch, rng=None, train=False):
            return super().__call__(batch, rng=None, train=train)

    jds, ds = datasets
    opt = dict(type="adam", lr=5e-4, lr_final=5e-6, lr_warmup_steps=2, lr_delay_mult=0.01, grad_clip=1e-3,
               max_steps=10)

    class Losses:
        def __init__(self):
            self.losses = []

        def on_run_begin(self, tr): ...

        def on_eval(self, tr, step): ...

        def on_run_end(self, tr): ...

        def after_step(self, tr, step, logs):
            self.losses.append(float(np.asarray(logs["loss"])))

    jrec, rec = Losses(), Losses()
    jtr = JTrainer(JDeterministic(**NET_KW), jds, optimizer=opt, work_dir=str(tmp_path / "jax"), max_iters=4,
                   ckpt_interval=0, log_interval=2, hooks=[jrec])
    p0 = jax.tree_util.tree_map(np.asarray, jtr.state.params)
    tr = Trainer(_Deterministic(**NET_KW), ds, optimizer=opt, work_dir=str(tmp_path / "torch"), max_iters=4,
                 ckpt_interval=0, log_interval=2, hooks=[rec], device="cpu")
    tr.network.load_state_dict({k: _t(v) for k, v in state_dict_from_jax(p0).items()})
    assert tr.grad_clip == 1e-3
    jtr.run()
    tr.run()
    np.testing.assert_allclose(rec.losses, jrec.losses, rtol=1e-5)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtr.state.params))
    moved = 0.0
    for k, p in tr.network.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[k], rtol=0, atol=5e-6, err_msg=k)
        moved = max(moved, float(np.abs(want[k] - state_dict_from_jax(p0)[k]).max()))
    assert moved > 1e-4  # the steps moved the weights by 20x the bound


def _mip_cfg(tmp_path, datadir):
    """``configs/mipnerf/mipnerf_multiscale.py`` as written, with the network
    narrowed and the data pointed at ``datadir``."""
    src = open(os.path.join(ROOT, "configs", "mipnerf", "mipnerf_multiscale.py")).read()
    cfg = tmp_path / "mip_cfg.py"
    cfg.write_text(
        src
        + f"""
model.update(n_samples=8, max_deg_point=4, netdepth=2, netwidth=16)
data.update(datadir=r"{datadir}", N_rand=64, testskip=2)
eval_chunk = 256
log_interval = 2
"""
    )
    return cfg


def test_cli_trains_and_tests_mipnerf(synthetic_scene, tmp_path):
    """``run_nerf`` trains the shrunk mip config on the CPU (its TestHook
    writes per-scale results at the end), then ``python -m
    xrnerf_torch.run_nerf --test_only`` from the weights gives the same
    per-scale PSNR."""
    cfg = _mip_cfg(tmp_path, synthetic_scene)
    wd = tmp_path / "wd"
    tr = run_nerf.main(["--config", str(cfg), "--device", "cpu", "--max_iters", "4", "--work_dir", str(wd)])
    assert tr.step == 4 and isinstance(tr.network, MipNerfNetwork) and tr.grad_clip == 1e-3
    assert tr.dataset.n_scales == 4 and np.isfinite(tr.last_logs["loss"])
    res = json.load(open(wd / "test" / "test_results.json"))
    assert sorted(res["psnr"]) == ["0", "1", "2", "3"]
    pt = tmp_path / "w.pt"
    torch.save(tr.network.state_dict(), pt)
    out = subprocess.run(
        [sys.executable, "-m", "xrnerf_torch.run_nerf", "--config", str(cfg), "--device", "cpu", "--test_only",
         "--load_from", str(pt), "--work_dir", str(tmp_path / "test_only")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    res2 = json.load(open(tmp_path / "test_only" / "test" / "test_results.json"))
    assert sorted(res2["psnr"]) == ["0", "1", "2", "3"]
    for s in res["psnr"]:
        assert res2["psnr"][s] == pytest.approx(res["psnr"][s], abs=1e-4)


def test_render_image_matches_jax(datasets, bridged):
    """``Trainer.render_image`` of one eval item at each scale against the
    JAX renderer with the same weights."""
    from xrnerf_tpu.core.renderer import render_image as jrender_image

    jnet, params, net = bridged
    jds, ds = datasets
    tr = Trainer(net, ds, work_dir=None, eval_chunk=100, device="cpu")
    tr.network.load_state_dict({k: _t(v) for k, v in state_dict_from_jax(params).items()})
    def apply_fn(p, bb, rng):
        return jnet.apply({"params": p}, bb, rng=None, train=False)

    for item in ds.i_test[:4]:
        rays, gt = ds.eval_item(int(item))
        got = tr.render_image(rays, gt.shape[0], gt.shape[1])
        want = jrender_image(apply_fn, params, rays, gt.shape[0], gt.shape[1], chunk=100)
        assert got["rgb"].shape == gt.shape
        for k in ("rgb", "acc"):
            _close_fine(got[k], want[k], ATOL, k)
