"""Vanilla NeRF's fused-path encoding (``xrnerf_torch/ops/nerf_posenc.py``).

- the plain version is ``posenc_fast`` of the points and of the view
  directions, each direction's encoding expanded to its ray's samples, bit
  for bit;
- a fused ``NerfNetwork`` gives the same bits on the CPU as with the encode
  stage it had before the kernel, and launches nothing there;
- the kernel's path refuses what the kernel does not take (inputs that need
  a gradient, other dtypes, encodings wider than the fused MLP reads);
- on the card (only), the kernel's outputs equal the plain version's run on
  the card, bit for bit, at the main path's shapes, and a fused network
  launches it once per MLP evaluation.

No JAX here, so the card tests run where JAX is not installed:
``XRNERF_TEST_TPU=1 python -m pytest tests/test_torch_nerf_posenc.py -m cuda``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import xrnerf_torch.models.networks.nerf as nerf_mod  # noqa: E402
import xrnerf_torch.ops.nerf_posenc as posenc_ops  # noqa: E402
from xrnerf_torch import build_network  # noqa: E402
from xrnerf_torch.models.embedders.posenc import posenc_fast  # noqa: E402
from xrnerf_torch.ops.fused_nerf_mlp import fused_nerf_mlp_fwd  # noqa: E402
from xrnerf_torch.ops.nerf_posenc import nerf_posenc, nerf_posenc_ref  # noqa: E402

L, LD = 10, 4  # configs/nerf/nerf_blender.py's multires / multires_dirs


def _inputs(n, s, seed=0, device="cpu"):
    """Points spread as a ray's samples are (|x| up to ~8), and unit directions."""
    rng = np.random.RandomState(seed)
    pts = (4.0 * rng.randn(n, s, 3)).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(pts).to(device), torch.from_numpy(d).to(device)


def _encode_before(pts, viewdirs, num_freqs, num_freqs_dirs):
    """The fused encode stage as ``NerfNetwork._eval_mlp`` wrote it before the kernel."""
    n, s, _ = pts.shape
    pts_enc = posenc_fast(pts.reshape(n * s, 3), num_freqs)
    views_enc = posenc_fast(viewdirs, num_freqs_dirs)
    views_enc = views_enc[:, None].expand(n, s, views_enc.shape[-1]).reshape(n * s, -1)
    return pts_enc, views_enc


def _eval_mlp_before(self, mlp, pts, viewdirs):
    n, s, _ = pts.shape
    pts_enc, views_enc = _encode_before(pts, viewdirs, self.multires, self.multires_dirs)
    rgb, sigma = mlp(pts_enc, views_enc)
    return rgb.reshape(n, s, 3), sigma.reshape(n, s)


# 37 rays: no multiple of the kernel's 256-row tile, nor of a warp or a 16-byte group of floats
@pytest.mark.parametrize("s", [1, 64, 192])
def test_plain_version_is_posenc_fast_expanded(s):
    pts, d = _inputs(37, s, seed=s)
    got = nerf_posenc_ref(pts, d, L, LD)
    want = _encode_before(pts, d, L, LD)
    assert got[0].shape == (37 * s, 63) and got[1].shape == (37 * s, 27)
    assert all(g.dtype == torch.float32 and g.is_contiguous() for g in got)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the CPU tensor takes the plain version
    again = nerf_posenc(pts, d, L, LD)
    assert torch.equal(again[0], want[0]) and torch.equal(again[1], want[1])


def _net(device, width):
    net = build_network(dict(type="NerfNetwork", n_samples=16, n_importance=16, netdepth=8, netwidth=width,
                             fused=True), device=device)
    net.reset_parameters(torch.Generator().manual_seed(0))
    return net


def _batch(n, device="cpu"):
    rng = np.random.RandomState(1)
    d = rng.randn(n, 3).astype(np.float32)
    b = {"rays_o": (0.3 * rng.randn(n, 3)).astype(np.float32), "rays_d": d,
         "near": np.full((n, 1), 2.0, np.float32), "far": np.full((n, 1), 6.0, np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


@pytest.mark.parametrize("train", [False, True])
def test_fused_network_on_cpu_unchanged_and_launches_nothing(train, monkeypatch):
    net, batch = _net("cpu", 32), _batch(45)
    before = nerf_posenc.launches
    got = net(batch, torch.Generator().manual_seed(3) if train else None, train=train)
    assert nerf_posenc.launches == before  # the CPU takes the plain version
    monkeypatch.setattr(nerf_mod.NerfNetwork, "_eval_mlp", _eval_mlp_before)
    want = net(batch, torch.Generator().manual_seed(3) if train else None, train=train)
    for k in ("rgb", "disp", "acc", "coarse_rgb"):
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("case", ["pts_grad", "viewdirs_grad", "float64", "pts_width", "view_width"])
def test_kernel_path_refuses(case, monkeypatch):
    """The card's path checks before it builds or launches anything: run here
    on meta tensors, with the shape check (which sends meta tensors away)
    taken out."""
    monkeypatch.setattr(posenc_ops, "_check_shapes", lambda pts, viewdirs: None)
    pts = torch.empty((4, 8, 3), device="meta", dtype=torch.float64 if case == "float64" else torch.float32)
    d = torch.empty((4, 3), device="meta", dtype=pts.dtype)
    freqs = {"pts_width": (11, LD), "view_width": (L, 5)}.get(case, (L, LD))
    if case.endswith("_grad"):
        (pts if case == "pts_grad" else d).requires_grad_()
    before = nerf_posenc.launches
    with pytest.raises(TypeError if case == "float64" else ValueError):
        nerf_posenc(pts, d, *freqs)
    assert nerf_posenc.launches == before


def test_shapes_refused():
    pts, d = _inputs(4, 8)
    with pytest.raises(ValueError):
        nerf_posenc(pts.reshape(32, 3), d, L, LD)
    with pytest.raises(ValueError):
        nerf_posenc(pts, d[:3], L, LD)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.device("cuda", 0)


# a render chunk's coarse and fine passes (16,384 rays x 64 and x 192 samples), the KiloNeRF
# teacher's S = 1, ragged ray counts
@pytest.mark.cuda
@pytest.mark.parametrize("n,s", [(16384, 64), (16384, 192), (70001, 1), (37, 192), (1, 1)])
def test_cuda_kernel_equals_plain_version(card, n, s):
    pts, d = _inputs(n, s, seed=n + s, device=card)
    before = nerf_posenc.launches
    got = nerf_posenc(pts, d, L, LD)
    torch.cuda.synchronize()
    assert nerf_posenc.launches == before + 1
    want = nerf_posenc_ref(pts, d, L, LD)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_cuda_kernel_rounds_as_the_plain_version_at_ties(card):
    """Points whose turns land on .5 ties, signed zeros, large and tiny values."""
    t = torch.tensor([0.5, -0.5, 1.5, 2.5, 0.0, -0.0, 1e-30, 3e4, -7.25, 1.0 / 3], dtype=torch.float32)
    x = (t * 6.283185307179586).float()
    pts = torch.stack([x, x.flip(0), -x], dim=-1).reshape(10, 1, 3).repeat(1, 3, 1).to(card)
    d = torch.stack([x, -x, x.flip(0)], dim=-1).to(card)
    for freqs in ((L, LD), (0, 0), (3, 1)):
        got, want = nerf_posenc(pts, d, *freqs), nerf_posenc_ref(pts, d, *freqs)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), freqs


@pytest.mark.cuda
def test_cuda_kernel_refuses_grad_inputs(card):
    pts, d = _inputs(4, 8, device=card)
    with pytest.raises(ValueError):
        nerf_posenc(pts.requires_grad_(), d, L, LD)


@pytest.mark.cuda
def test_cuda_network_launches_once_per_mlp_and_keeps_its_bits(card, monkeypatch):
    net, batch = _net(card, 256), _batch(1000, card)
    before = (nerf_posenc.launches, fused_nerf_mlp_fwd.launches)
    got = net(batch)
    torch.cuda.synchronize()
    assert (nerf_posenc.launches - before[0], fused_nerf_mlp_fwd.launches - before[1]) == (2, 2)
    rgb, sigma = net.eval_field(batch["rays_o"], batch["rays_d"])
    assert nerf_posenc.launches - before[0] == 3
    monkeypatch.setattr(nerf_mod, "nerf_posenc", nerf_posenc_ref)
    want = net(batch)
    want_rgb, want_sigma = net.eval_field(batch["rays_o"], batch["rays_d"])
    assert nerf_posenc.launches - before[0] == 3
    for k in ("rgb", "disp", "acc", "coarse_rgb"):
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(rgb, want_rgb) and torch.equal(sigma, want_sigma)
