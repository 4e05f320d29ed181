"""GNR image encoders and coordinate / direction embedders — port of
``xrnerf_tpu/models/embedders/gnr_embedder.py``.

- ``ConvBlock``: residual block, 3x3 convs at C/2, C/4, C/4 concatenated;
- ``HourGlass``: recursive pool-down / cubic-upsample-add pyramid;
- ``HGFilter``: PIFu's stacked-hourglass image encoder;
- ``SRFilters``: pixel-aligned feature up-sampler fusing the image;
- ``gnr_posenc``: linear-frequency-band Fourier features;
- ``spherical_harmonics``: real SH by the Legendre recurrence.

Layout: NCHW inside (cuDNN's), where the JAX modules run NHWC; an encoder
takes and returns NCHW. Module and parameter names are flax's, so
``utils/weights.py`` carries a flax tree across.

Three pieces follow flax and ``jax.image`` rather than torch's defaults:

- ``GroupNorm``: 32 groups, epsilon 1e-6, flax's fast variance
  max(E[x^2] - E[x]^2, 0) and y = (x - mean) * (rsqrt(var + eps) * scale)
  + bias; its parameters are ``scale`` and ``bias``;
- ``cubic_resize``: ``jax.image.resize(..., "cubic")`` — Keys' kernel with
  a = -0.5, the weights of each output sample renormalised to sum to 1 at
  the edges, the kernel widened by 1/scale when down-sampling
  (``antialias``), one weight matrix per axis. torch's ``bicubic`` uses
  a = -0.75 with clamped edges;
- padding: flax's ``SAME`` for the stride-1 convs, explicit 3 for the 7x7
  stride-2 stem, ``SAME`` (0 before, 1 after on even sizes) for the
  stride-2 ``down_conv2``, and VALID 2x2 average pooling.

Only group norm is ported: the JAX network never builds the batch-norm
branch of ``_norm``.

``dtype`` (f32 by default) is flax's compute dtype of every conv
(``utils/dtype.py:Conv2d``). GroupNorm has none in JAX: it takes its statistics
in f32, and its f32 scale and bias turn a bf16 input into an f32 output,
which the next conv casts back. The cubic resize runs in its input's dtype,
its weights cast to it, as ``jax.image.resize`` does.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...registry import EMBEDDERS
from ...utils.dtype import Conv2d, resolve_dtype
from ..fields.nerf_mlp import flax_init_ as nerf_flax_init_


def flax_init_(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """flax's initialisation of every ``Linear`` and ``Conv2d`` under
    ``module`` (``fields/nerf_mlp.py:flax_init_``), and GroupNorm's scale 1,
    bias 0."""
    nerf_flax_init_(module, generator)
    for m in module.modules():
        if isinstance(m, GroupNorm):
            with torch.no_grad():
                m.scale.fill_(1.0)
                m.bias.zero_()


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=32)`` on NCHW."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """f32 statistics and output for any input dtype, as flax's (built
        without ``dtype``, f32 parameters)."""
        x = x.float()
        n, c = x.shape[:2]
        g = x.reshape(n, self.num_groups, -1)
        mean = g.mean(-1, keepdim=True)
        var = torch.clamp((g * g).mean(-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps)  # [n, G, 1]
        shape = (n, self.num_groups, c // self.num_groups, -1)
        mul = mul[..., None] * self.scale.reshape(1, self.num_groups, -1, 1)
        y = (g.reshape(shape) - mean[..., None]) * mul + self.bias.reshape(1, self.num_groups, -1, 1)
        return y.reshape(x.shape)


def _conv(cin: int, cout: int, k: int, bias: bool = True, dtype=torch.float32) -> Conv2d:
    """A stride-1 conv with flax's ``SAME`` padding (odd kernels)."""
    return Conv2d(cin, cout, k, padding=k // 2, bias=bias, dtype=dtype)


# ---------------------------------------------------------------------------
# jax.image.resize(..., "cubic") as one weight matrix per axis
# ---------------------------------------------------------------------------
_RESIZE_WEIGHTS: Dict[Tuple[int, int, str], torch.Tensor] = {}


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def cubic_weight_mat(m: int, n: int, device) -> torch.Tensor:
    """[m, n] weights from ``m`` input to ``n`` output samples
    (``jax._src.image.scale.compute_weight_mat``, cubic, antialias, no
    translation), made on ``device`` once and cached."""
    key = (m, n, str(device))
    if key not in _RESIZE_WEIGHTS:
        scale = float(np.float32(n / m))
        inv_scale = 1.0 / scale
        kernel_scale = max(inv_scale, 1.0)
        sample_f = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
        x = torch.abs(sample_f[None, :] - torch.arange(m, dtype=torch.float32, device=device)[:, None]) / kernel_scale
        w = _keys_cubic(x)
        total = w.sum(0, keepdim=True)
        w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                        w / torch.where(total != 0, total, 1.0), 0.0)
        inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
        _RESIZE_WEIGHTS[key] = torch.where(inside[None, :], w, 0.0)
    return _RESIZE_WEIGHTS[key]


def cubic_resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, ..., "cubic")`` of NCHW ``x`` to ``size`` (h, w)."""
    h, w = x.shape[-2:]
    if (h, w) == tuple(size):
        return x
    if h != size[0]:
        x = torch.einsum("nchw,hH->ncHw", x, cubic_weight_mat(h, size[0], x.device).to(x.dtype))
    if w != size[1]:
        x = torch.einsum("nchw,wW->nchW", x, cubic_weight_mat(w, size[1], x.device).to(x.dtype))
    return x


def _resize2x(x: torch.Tensor) -> torch.Tensor:
    return cubic_resize(x, (2 * x.shape[-2], 2 * x.shape[-1]))


# ---------------------------------------------------------------------------
# Image encoders
# ---------------------------------------------------------------------------
class ConvBlock(nn.Module):
    """Residual conv block: 3x3 convs at C/2, C/4, C/4, concatenated.
    ``dtype``: the convs' compute dtype (the JAX field
    ``xrnerf_tpu/models/embedders/gnr_embedder.py:43``)."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32):
        super().__init__()
        dt = resolve_dtype(dtype)
        c = out_ch
        self.bn1, self.conv1 = GroupNorm(in_ch), _conv(in_ch, c // 2, 3, bias=False, dtype=dt)
        self.bn2, self.conv2 = GroupNorm(c // 2), _conv(c // 2, c // 4, 3, bias=False, dtype=dt)
        self.bn3, self.conv3 = GroupNorm(c // 4), _conv(c // 4, c // 4, 3, bias=False, dtype=dt)
        if in_ch != c:
            self.bn4, self.down = GroupNorm(in_ch), _conv(in_ch, c, 1, bias=False, dtype=dt)
        else:
            self.down = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h1 = self.conv1(F.relu(self.bn1(x)))
        h2 = self.conv2(F.relu(self.bn2(h1)))
        h3 = self.conv3(F.relu(self.bn3(h2)))
        if self.down is not None:
            x = self.down(F.relu(self.bn4(x)))
        return torch.cat([h1, h2, h3], 1) + x


class HourGlass(nn.Module):
    """Recursive hourglass: pool -> recurse -> upsample-add skip; blocks
    named ``b1_{lv}``, ``b2_{lv}``, ``b2_plus_1``, ``b3_{lv}`` as in flax.
    ``dtype``: its blocks' (the JAX field ``gnr_embedder.py:77``)."""

    def __init__(self, depth: int, features: int, dtype=torch.float32):
        super().__init__()
        self.depth = depth
        for lv in range(depth, 0, -1):
            for name in (f"b1_{lv}", f"b2_{lv}", f"b3_{lv}") + (("b2_plus_1",) if lv == 1 else ()):
                self.add_module(name, ConvBlock(features, features, dtype))

    def _level(self, inp: torch.Tensor, lv: int) -> torch.Tensor:
        up1 = getattr(self, f"b1_{lv}")(inp)
        low = getattr(self, f"b2_{lv}")(F.avg_pool2d(inp, 2, 2))
        low = self._level(low, lv - 1) if lv > 1 else self.b2_plus_1(low)
        low = getattr(self, f"b3_{lv}")(low)
        return up1 + _resize2x(low)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._level(x, self.depth)


@EMBEDDERS.register
class HGFilter(nn.Module):
    """Stacked-hourglass image encoder: [V, 3, H, W] -> [V, hourglass_dim, H/4, W/4]
    in ``dtype``, the convs' compute dtype (the JAX field
    ``gnr_embedder.py:106``)."""

    def __init__(self, num_stack: int = 4, num_hourglass: int = 2, hourglass_dim: int = 256,
                 norm: str = "group", hg_down: str = "ave_pool", dtype=torch.float32):
        super().__init__()
        dt = resolve_dtype(dtype)
        if norm != "group":
            raise ValueError(f"HGFilter: only group norm is ported, got {norm!r}")
        if hg_down not in ("ave_pool", "conv64", "conv128"):
            raise ValueError(f"unknown hg_down {hg_down!r}")
        self.num_stack, self.hg_down = num_stack, hg_down
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, dtype=dt)
        self.bn1 = GroupNorm(64)
        c2 = {"ave_pool": 128, "conv64": 64, "conv128": 128}[hg_down]
        self.conv2 = ConvBlock(64, c2, dt)
        if hg_down != "ave_pool":
            self.down_conv2 = Conv2d(c2, 128, 3, stride=2, dtype=dt)
        self.conv3 = ConvBlock(128, 128, dt)
        self.conv4 = ConvBlock(128, 256, dt)
        for i in range(num_stack):
            self.add_module(f"m{i}", HourGlass(num_hourglass, 256, dt))
            self.add_module(f"top_m_{i}", ConvBlock(256, 256, dt))
            self.add_module(f"conv_last{i}", _conv(256, 256, 1, dtype=dt))
            self.add_module(f"bn_end{i}", GroupNorm(256))
            self.add_module(f"l{i}", _conv(256, hourglass_dim, 1, dtype=dt))
            if i < num_stack - 1:
                self.add_module(f"bl{i}", _conv(256, 256, 1, dtype=dt))
                self.add_module(f"al{i}", _conv(hourglass_dim, 256, 1, dtype=dt))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        flax_init_(self, generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(images)))
        x = self.conv2(x)
        if self.hg_down == "ave_pool":
            x = F.avg_pool2d(x, 2, 2)
        else:  # flax's SAME at stride 2: the odd pixel of padding goes after
            h, w = x.shape[-2:]
            ph, pw = max((h + 1) // 2 * 2 + 1 - h, 0), max((w + 1) // 2 * 2 + 1 - w, 0)
            x = self.down_conv2(F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2)))
        x = self.conv4(self.conv3(x))
        previous, tmp_out = x, None
        for i in range(self.num_stack):
            hg = getattr(self, f"m{i}")(previous)
            ll = getattr(self, f"top_m_{i}")(hg)
            ll = F.relu(getattr(self, f"bn_end{i}")(getattr(self, f"conv_last{i}")(ll)))
            tmp_out = getattr(self, f"l{i}")(ll)
            if i < self.num_stack - 1:
                previous = previous + getattr(self, f"bl{i}")(ll) + getattr(self, f"al{i}")(tmp_out)
        return tmp_out


@EMBEDDERS.register
class SRFilters(nn.Module):
    """Feature super-resolution: up-sample 2x per order, fusing the image
    (cubic-resized to each scale): feat [V, C, h, w], images [V, 3, H, W].
    ``dtype``: the convs' compute dtype (the JAX field
    ``gnr_embedder.py:160``)."""

    def __init__(self, order: int = 2, out_ch: int = 128, in_ch: int = 256, dtype=torch.float32):
        super().__init__()
        self.order = order
        for i in range(order + 1):
            self.add_module(f"conv{i}", _conv((in_ch if i == 0 else out_ch) + 3, out_ch, 3, dtype=resolve_dtype(dtype)))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        flax_init_(self, generator)

    def forward(self, feat: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
        H, W = images.shape[-2:]
        for i in range(self.order + 1):
            f = 0.5 ** (self.order - i)
            im = cubic_resize(images, (int(H * f), int(W * f))) if f != 1 else images
            if i != 0:
                feat = _resize2x(feat)
            feat = getattr(self, f"conv{i}")(torch.cat([feat, im], 1))
        return feat


# ---------------------------------------------------------------------------
# Coordinate / direction embedders (stateless)
# ---------------------------------------------------------------------------
def gnr_posenc_freqs(num_freqs: int, min_freq: Optional[float] = None, max_freq: Optional[float] = None) -> np.ndarray:
    """Linear frequency bands in [min*2pi, max*2pi] (the reference's
    ``PositionalEncoding`` 'linear' bands)."""
    lo = 0.0 if min_freq is None else min_freq
    hi = float(2 ** (num_freqs - 1)) if max_freq is None else max_freq
    return np.linspace(lo * 2 * math.pi, hi * 2 * math.pi, num_freqs).astype(np.float32)


def gnr_posenc(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """[..., d] -> [..., d * (1 + 2F)]: identity, then sin and cos per band."""
    xb = x[..., None, :] * freqs[:, None]  # [..., F, d]
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], -1)
    return torch.cat([x, enc.reshape(*x.shape[:-1], -1)], -1)


def gnr_posenc_dim(d: int, num_freqs: int) -> int:
    return d * (1 + 2 * num_freqs)


def spherical_harmonics(xyz: torch.Tensor, rank: int = 3) -> torch.Tensor:
    """Real SH basis at unit dirs by the Legendre recurrence -> [..., rank^2]."""
    cs, sn, z = xyz[..., 0:1], xyz[..., 1:2], xyz[..., 2:3]
    omx = cs * cs + sn * sn
    # associated Legendre P_l^m(z) at index l(l+1)/2 + m
    Fml = [None] * ((rank + 1) * rank // 2)
    Fml[0] = torch.ones_like(z)
    for l in range(1, rank):
        b = (l * l + l) // 2
        Fml[b + l] = -Fml[b - 1] * (2 * l - 1)
        Fml[b + l - 1] = Fml[b - 1] * (2 * l - 1) * z
        for m in range(l, 1, -1):
            Fml[b + m - 2] = -(omx * Fml[b + m] + 2 * (m - 1) * z * Fml[b + m - 1]) / ((l - m + 2) * (l + m - 1))
    H = [None] * (rank * rank)
    for l in range(rank):
        b = l * l + l
        attr = np.sqrt((2 * l + 1) / math.pi / 4)
        H[b] = float(attr) * Fml[b // 2]
        attr = attr * np.sqrt(2)
        snM, csM = sn, cs
        for m in range(1, l + 1):
            attr = -attr / np.sqrt((l + m) * (l + 1 - m))
            H[b - m] = float(attr) * Fml[b // 2 + m] * snM
            H[b + m] = float(attr) * Fml[b // 2 - m] * csM
            snM, csM = snM * cs + csM * sn, csM * cs - snM * sn
    return torch.cat(H, -1)


def sh_dim(rank: int = 3, d: int = 3) -> int:
    return rank * rank * (d // 3)
