"""NerfMLP and the fused-MLP op of the PyTorch port, held against the JAX package.

- weights cross over through ``xrnerf_torch/utils/weights.py`` and back;
- the unfused (f32) ``NerfMLP`` matches flax at atol 1e-4;
- the fused op's plain version matches the JAX ``fused_nerf_mlp`` (Pallas
  in interpret mode on the CPU) at rtol 2e-2 / atol 8e-3, the tolerances
  of ``tests/test_fused_nerf_mlp.py``;
- the kernels' weight image holds every pack element once, in the swizzled
  block order the kernels read, and the backward's grid schedule covers
  every row once;
- on the card (only), the CUDA kernels, forward and backward, match their
  plain versions, at row counts around every tile edge.

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
    KERNEL_SLAB,
    KERNEL_TILE,
    bwd_schedule,
    fused_nerf_mlp_bwd,
    fused_nerf_mlp_bwd_ref,
    fused_nerf_mlp_fwd,
    fused_nerf_mlp_ref,
    pack_params,
    unpack_params,
    weight_image,
    weight_image_index,
    with_image,
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


def _random_pack(din, dv, seed=0):
    mlp = NerfMLP(netwidth=256, in_ch=din, in_ch_views=dv)
    mlp.reset_parameters(torch.Generator().manual_seed(seed))
    return pack_params(mlp.state_dict(), din, dv)


@pytest.mark.parametrize("din,dv", [(63, 27), (64, 32)])
def test_weight_image_round_trip(din, dv):
    """Image -> pack is exact and every pack element appears exactly once;
    the rest of the image is padding, read as zero."""
    packed = _random_pack(din, dv)
    total = packed.weights.numel()
    idx = weight_image_index(packed.width, packed.px, packed.pv)
    valid = idx < total
    assert idx.max() == total and np.array_equal(np.sort(idx[valid]), np.arange(total))
    # 601,088 bf16: the pack plus views_0's view columns padded from 32 to 64
    assert idx.size == total + 128 * 32 and idx.size * 2 % 1024 == 0
    image = weight_image(packed)
    assert image.dtype == torch.bfloat16 and image.shape == (idx.size,)
    assert float(image[torch.from_numpy(~valid)].abs().max()) == 0.0
    back = torch.zeros_like(packed.weights)
    back[torch.from_numpy(idx[valid])] = image[torch.from_numpy(valid)]
    assert torch.equal(back, packed.weights)


@pytest.mark.parametrize("name,row,col,offset", [
    # w0 is the image's first 32 KB slab: one column block, four row blocks of 64 x 64
    ("w0", 0, 0, 0), ("w0", 0, 8, 8), ("w0", 1, 0, 64 + 8), ("w0", 9, 62, 9 * 64 + (7 ^ 1) * 8 + 6),
    ("w0", 64, 0, 4096), ("w0", 255, 63, 3 * 4096 + 63 * 64 + (7 ^ 7) * 8 + 7),
    # w1 follows; its blocks are ordered column-block-major: (c, ob) at (4 c + ob) * 4096
    ("w1", 0, 0, 16384), ("w1", 9, 70, 16384 + (4 * 1 + 0) * 4096 + 9 * 64 + (0 ^ 1) * 8 + 6),
    ("w1", 200, 130, 16384 + (4 * 2 + 3) * 4096 + 8 * 64 + (0 ^ 0) * 8 + 2),
    # the alpha head after w7: [8][64] chunks of 512 values
    ("wa", 0, 0, 16384 * 2 + 65536 * 7), ("wa", 0, 64, 16384 * 2 + 65536 * 7 + 512),
])
def test_weight_image_positions(name, row, col, offset):
    packed = _random_pack(64, 32, seed=1)
    image = weight_image(packed)
    assert image[offset] == unpack_params(packed)[name][row, col]


@pytest.mark.parametrize("n,sms,want", [
    (1, 132, (128, 1, 64, 2)),
    (128, 132, (128, 1, 64, 2)),
    (129, 132, (256, 2, 64, 4)),
    (300, 132, (384, 3, 64, 6)),
    (1000, 132, (1024, 8, 128, 8)),
    (132 * 128 + 1, 132, (17_024, 132, 1_472, 12)),
    (262_144, 132, (262_144, 132, 21_888, 12)),
    (786_432, 132, (786_432, 132, 65_536, 12)),
    (70_001, 114, (70_016, 114, 7_040, 10)),
])
def test_bwd_schedule_cases(n, sms, want):
    assert bwd_schedule(n, sms) == want


def test_with_image_builds_the_image_once():
    """A pack keeps the image it was given; one without gets it built."""
    packed = _random_pack(63, 27)
    assert packed.image is None  # a CPU pack carries none until asked
    first = with_image(packed)
    assert torch.equal(first.image, weight_image(packed)) and first.weights is packed.weights
    assert with_image(first) is first


def test_bwd_schedule_covers_every_row_once():
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=200, deadline=None)
    @hypothesis.given(st.integers(1, 4_000_000), st.integers(1, 200))
    def check(n, sms):
        npad, grid, kchunk, splits = bwd_schedule(n, sms)
        assert npad % KERNEL_TILE == 0 and n <= npad < n + KERNEL_TILE
        assert 1 <= grid <= sms
        tiles = npad // KERNEL_TILE
        walked = sorted(t for cta in range(grid) for t in range(cta, tiles, grid))
        assert walked == list(range(tiles))  # the row pass: every tile once
        assert kchunk % KERNEL_SLAB == 0
        chunks = [(s * kchunk, min((s + 1) * kchunk, npad)) for s in range(splits)]
        assert chunks[0][0] == 0 and chunks[-1][1] == npad and all(a < b for a, b in chunks)
        assert all(chunks[i][1] == chunks[i + 1][0] for i in range(splits - 1))

    check()


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
    for n in (1, 63, 64, 65, 127, 128, 129, 1000, 132 * KERNEL_TILE + 1, 70001):
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
    norm ratio 0.93-1.07 (the JAX package's gradient bars) for N >= 63, an
    absolute bar for the one-row case; a failure names the worst leaf. The
    weight gradients are the same bits on a second launch."""
    packed = _cuda_pack()
    for n in (1, 63, 64, 65, 127, 128, 129, 1000, 132 * KERNEL_TILE + 1, 70001):
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
        report = sorted(
            (_cos(a, b), float(a.norm() / (b.norm() + 1e-30)), float((a - b).abs().max()), float(b.abs().max()), name)
            for name, a, b in leaves
        )
        worst = "N=%d worst leaf %s: cosine %.6f, norm ratio %.5f, max abs err %.3e (leaf max %.3e)" % (
            n, report[0][4], *report[0][:4])
        if n == 1:
            # one row: a single bf16 rounding flip decides a cosine, so every value is held to
            # 3 % of its leaf's largest entry instead
            assert all(err <= 0.03 * top + 1e-6 for _, _, err, top, _ in report), worst
        else:
            assert all(c > 0.99 and 0.93 < r < 1.07 for c, r, _, _, _ in report), worst
        again = fused_nerf_mlp_bwd(x, v, g, packed)
        assert torch.equal(again[2], got[2]) and torch.equal(again[3], got[3])
