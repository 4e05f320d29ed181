"""NerfMLP and the fused-MLP op of the PyTorch port, held against the JAX package.

- weights cross over through ``xrnerf_torch/utils/weights.py`` and back;
- the unfused (f32) ``NerfMLP`` matches flax at atol 1e-4;
- the fused op's plain version matches the JAX ``fused_nerf_mlp`` (Pallas
  in interpret mode on the CPU) at rtol 2e-2 / atol 8e-3, the tolerances
  of ``tests/test_fused_nerf_mlp.py``;
- on the card (only), the CUDA kernels, forward and backward, match their
  plain versions.

JAX is imported inside the tests that compare with it, so the card tests
run where JAX is not installed:
``XRNERF_TEST_TPU=1 python -m pytest tests/test_torch_nerf_mlp.py -m cuda``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from xrnerf_torch.models.fields.nerf_mlp import NerfMLP  # noqa: E402
from xrnerf_torch.ops.fused_nerf_mlp import (  # noqa: E402
    fused_nerf_mlp_bwd,
    fused_nerf_mlp_bwd_ref,
    fused_nerf_mlp_fwd,
    fused_nerf_mlp_ref,
    pack_params,
)
from xrnerf_torch.utils.weights import (  # noqa: E402
    jax_params_from_state_dict,
    state_dict_from_jax,
)

RTOL, ATOL = 2e-2, 8e-3


def _data(n, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(n, 63).astype(np.float32), rng.randn(n, 27).astype(np.float32)


def _flax_params(width, seed, n=8):
    import jax

    from xrnerf_tpu.models.fields.nerf_mlp import NerfMLP as JNerfMLP

    x, v = _data(n)
    mod = JNerfMLP(netwidth=width)
    params = mod.init(jax.random.PRNGKey(seed), x, v)["params"]
    return mod, jax.tree_util.tree_map(np.asarray, params)


def _torch_mlp(params, width, fused=False):
    mlp = NerfMLP(netwidth=width, fused=fused)
    mlp.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict_from_jax(params).items()})
    return mlp


def test_weights_round_trip():
    _, params = _flax_params(64, seed=0)
    mlp = _torch_mlp(params, 64)
    assert mlp.pts_5.weight.shape == (64, 63 + 64)  # nn.Linear is [out, in]
    back = jax_params_from_state_dict(mlp.state_dict())
    assert sorted(back) == sorted(params)
    for name, leaf in params.items():
        np.testing.assert_array_equal(back[name]["kernel"], leaf["kernel"])
        np.testing.assert_array_equal(back[name]["bias"], leaf["bias"])


def test_flax_init_distribution():
    """reset_parameters follows flax's lecun-normal: truncated at 2 std,
    variance 1/fan_in, zero biases."""
    mlp = NerfMLP(netwidth=256)
    mlp.reset_parameters(torch.Generator().manual_seed(0))
    w = mlp.pts_1.weight.detach()
    assert float(w.std()) == pytest.approx(1 / 16, rel=0.03)
    assert float(w.abs().max()) <= 2 * (1 / 16) / 0.87962566103423978 + 1e-6
    assert float(mlp.pts_1.bias.detach().abs().max()) == 0.0


@pytest.mark.parametrize("width", [64, 256])
def test_unfused_mlp_matches_flax(width):
    mod, params = _flax_params(width, seed=1)
    x, v = _data(300, seed=2)
    want = mod.apply({"params": params}, x, v)
    with torch.no_grad():
        got = _torch_mlp(params, width)(torch.from_numpy(x), torch.from_numpy(v))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


@pytest.mark.parametrize("n", [64, 70, 1500])
def test_fused_plain_matches_jax_fused(n):
    from xrnerf_tpu.ops.pallas.fused_nerf_mlp import fused_nerf_mlp as jfused

    _, params = _flax_params(256, seed=3)
    x, v = _data(n, seed=n)
    want_rgb, want_sigma = jfused(x, v, params)
    sd = {k: torch.from_numpy(a) for k, a in state_dict_from_jax(params).items()}
    rgb, sigma = fused_nerf_mlp_fwd(torch.from_numpy(x), torch.from_numpy(v), pack_params(sd, 63, 27))
    assert rgb.shape == (n, 3) and sigma.shape == (n,)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(want_rgb), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(want_sigma), rtol=RTOL, atol=ATOL)


def test_fused_module_cpu_uses_plain_version_and_counts_nothing():
    _, params = _flax_params(64, seed=4)
    x, v = (torch.from_numpy(a) for a in _data(50, seed=5))
    before = fused_nerf_mlp_fwd.launches
    fused = _torch_mlp(params, 64, fused=True)
    with torch.no_grad():
        rgb, sigma = fused(x, v)
        rgb0, sigma0 = _torch_mlp(params, 64)(x, v)
    assert fused_nerf_mlp_fwd.launches == before
    np.testing.assert_allclose(rgb.numpy(), rgb0.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sigma.numpy(), sigma0.numpy(), rtol=RTOL, atol=ATOL)
    pack = fused.packed()
    assert fused.packed() is pack  # cached while the weights are unchanged
    with torch.no_grad():
        fused.pts_3.bias.add_(1.0)
    assert fused.packed() is not pack


def test_fused_requires_reference_topology():
    with pytest.raises(ValueError, match="netdepth=8"):
        NerfMLP(netdepth=4, fused=True)


def _cuda_pack():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    rng = np.random.RandomState(0)
    mlp = NerfMLP(netwidth=256)
    mlp.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in mlp.parameters():
            if p.dim() == 1:
                p.copy_(torch.from_numpy(0.1 * rng.randn(p.shape[0]).astype(np.float32)))
    sd = {k: t.cuda() for k, t in mlp.state_dict().items()}
    return pack_params(sd, 63, 27)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    packed = _cuda_pack()
    for n in (1, 127, 1000, 70001):
        x, v = (torch.from_numpy(a).cuda() for a in _data(n, seed=n))
        before = fused_nerf_mlp_fwd.launches
        rgb, sigma = fused_nerf_mlp_fwd(x, v, packed)
        torch.cuda.synchronize()
        assert fused_nerf_mlp_fwd.launches == before + 1
        ref_rgb, ref_sigma = fused_nerf_mlp_ref(x, v, packed)
        torch.testing.assert_close(rgb, ref_rgb, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(sigma, ref_sigma, rtol=RTOL, atol=ATOL)


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


@pytest.mark.cuda
def test_cuda_backward_kernel_matches_plain_version():
    """dx, dv and the weight and bias gradients per leaf: cosine > 0.99 and
    norm ratio 0.93-1.07 (the JAX package's gradient bars); the weight
    gradients are the same bits on a second launch."""
    from xrnerf_torch.ops.fused_nerf_mlp import unpack_params

    packed = _cuda_pack()
    for n in (1, 127, 1000, 70001):
        x, v = (torch.from_numpy(a).cuda() for a in _data(n, seed=n))
        g = torch.from_numpy(np.random.RandomState(n + 1).randn(n, 4).astype(np.float32)).cuda()
        before = fused_nerf_mlp_bwd.launches
        got = fused_nerf_mlp_bwd(x, v, g, packed)
        torch.cuda.synchronize()
        assert fused_nerf_mlp_bwd.launches == before + 1
        want = fused_nerf_mlp_bwd_ref(x, v, g, packed)
        gp = unpack_params(packed._replace(weights=got[2], biases=got[3]))
        wp = unpack_params(packed._replace(weights=want[2], biases=want[3]))
        leaves = [("dx", got[0], want[0]), ("dv", got[1], want[1])] + [(k, gp[k], wp[k]) for k in gp]
        for name, a, b in leaves:
            assert _cos(a, b) > 0.99, f"N={n} {name}: cos {_cos(a, b)}"
            ratio = float(a.norm() / b.norm())
            assert 0.93 < ratio < 1.07, f"N={n} {name}: norm ratio {ratio}"
        again = fused_nerf_mlp_bwd(x, v, g, packed)
        assert torch.equal(again[2], got[2]) and torch.equal(again[3], got[3])
