"""Vanilla NeRF MLP field — port of ``xrnerf_tpu/models/fields/nerf_mlp.py``.

8x256 trunk with the input skip-concat ``[x, h]`` after layer 4, separate
alpha/feature heads and a width/2 view-conditioned rgb head. Parameter
names match the flax tree (``pts_0..7``, ``alpha``, ``feature``,
``views_0``, ``rgb``; ``output`` without view dirs), so a flax checkpoint
maps one-to-one through ``utils/weights.py``.

``fused=False`` runs ``nn.Linear`` in ``dtype`` (see the class).
``fused=True`` needs the reference topology (netdepth 8, skip at 4, view dirs) and routes the whole
MLP through ``ops/fused_nerf_mlp.py`` (the CUDA kernels on the card, their
plain versions on the CPU). When a parameter needs a gradient it packs the
live parameters each call and runs the autograd op (forward and backward
kernels); otherwise (serving, ``inference_mode``) it runs the forward
kernel on a bf16 pack cached per weight version.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.fused_nerf_mlp import fused_nerf_mlp, fused_nerf_mlp_fwd, pack_params
from ...utils.dtype import Dense, resolve_dtype

# flax lecun_normal: truncated normal on [-2, 2] std, rescaled so the
# variance is 1/fan_in (jax.nn.initializers.variance_scaling).
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(layer: nn.Module, generator: Optional[torch.Generator]) -> None:
    """flax ``Dense`` / ``Conv`` init: lecun-normal (truncated) kernel over
    the fan-in (``in`` for a ``Linear``, ``in * kh * kw`` or
    ``in * kd * kh * kw`` for a conv), zero bias where there is one."""
    std = math.sqrt(1.0 / layer.weight[0].numel()) / _TRUNC_STD
    w = torch.empty(layer.weight.shape, dtype=torch.float32)
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    with torch.no_grad():
        layer.weight.copy_(w)
        if layer.bias is not None:
            layer.bias.zero_()


def embed_normal_(embedding: nn.Embedding, generator: Optional[torch.Generator]) -> None:
    """flax ``Embed`` init (``default_embed_init``): normal, std 1/sqrt(features)."""
    w = torch.empty(embedding.weight.shape, dtype=torch.float32)
    nn.init.normal_(w, 0.0, 1.0 / math.sqrt(embedding.embedding_dim), generator=generator)
    with torch.no_grad():
        embedding.weight.copy_(w)


def flax_init_(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """flax's initialisation for every ``Linear``, ``Conv2d``, ``Conv3d`` and
    ``Embedding`` under ``module``, in registration order."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            lecun_normal_(m, generator)
        elif isinstance(m, nn.Embedding):
            embed_normal_(m, generator)


class NerfMLP(nn.Module):
    """``dtype`` is flax's compute dtype (the JAX field
    ``xrnerf_tpu/models/fields/nerf_mlp.py:27``, used at ``:79-96``; f32 by
    default, a name or a ``torch.dtype``, ``utils/dtype.py``): the encodings
    go in cast to ``dtype`` and raw rgb and sigma come out f32. ``fused=True``
    ignores it, as in JAX."""

    def __init__(
        self,
        in_ch: int = 63,
        in_ch_views: int = 27,
        netdepth: int = 8,
        netwidth: int = 256,
        skips: Sequence[int] = (4,),
        use_viewdirs: bool = True,
        fused: bool = False,
        dtype=torch.float32,
    ):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.netdepth, self.netwidth = netdepth, netwidth
        self.skips = tuple(skips)
        self.use_viewdirs = use_viewdirs
        self.fused = fused
        self.in_ch, self.in_ch_views = in_ch, in_ch_views
        if fused and not (netdepth == 8 and self.skips == (4,) and use_viewdirs):
            raise ValueError(
                "NerfMLP(fused=True) requires netdepth=8, skips=(4,), use_viewdirs=True"
            )
        w = netwidth
        for i in range(netdepth):
            skip_in = i > 0 and (i - 1) in self.skips and (i - 1) != netdepth - 1
            din = in_ch if i == 0 else (in_ch + w if skip_in else w)
            setattr(self, f"pts_{i}", Dense(din, w, dtype=self.dtype))
        if use_viewdirs:
            self.alpha = Dense(w, 1, dtype=self.dtype)
            self.feature = Dense(w, w, dtype=self.dtype)
            self.views_0 = Dense(w + in_ch_views, w // 2, dtype=self.dtype)
            self.rgb = Dense(w // 2, 3, dtype=self.dtype)
        else:
            self.output = Dense(w, 4, dtype=self.dtype)
        self._pack_key = None
        self._pack = None

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        flax_init_(self, generator)

    def packed(self):
        """The kernel's weight pack, rebuilt when a parameter changes."""
        params = list(self.parameters())
        key = tuple((p.data_ptr(), p._version) for p in params)
        if key != self._pack_key:
            sd = {k: v.detach() for k, v in self.state_dict().items()}
            self._pack = pack_params(sd, self.in_ch, self.in_ch_views)
            self._pack_key = key
        return self._pack

    def forward(
        self, pts_enc: torch.Tensor, views_enc: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """pts_enc [..., Cp], views_enc [..., Cv] -> (raw_rgb [..., 3], raw_sigma [...])."""
        if self.fused:
            if views_enc is None:
                raise ValueError("NerfMLP(fused=True) needs views_enc")
            lead = pts_enc.shape[:-1]
            x = pts_enc.reshape(-1, pts_enc.shape[-1]).float().contiguous()
            v = views_enc.reshape(-1, views_enc.shape[-1]).float().contiguous()
            if torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters()):
                rgb, sigma = fused_nerf_mlp(x, v, dict(self.named_parameters()))
            else:
                rgb, sigma = fused_nerf_mlp_fwd(x, v, self.packed())
            return rgb.reshape(*lead, 3), sigma.reshape(lead)
        dt = self.dtype
        x = pts_enc.to(dt)
        h = x
        for i in range(self.netdepth):
            h = F.relu(getattr(self, f"pts_{i}")(h))
            if i in self.skips and i != self.netdepth - 1:
                h = torch.cat([x, h], dim=-1)
        if self.use_viewdirs:
            sigma = self.alpha(h)[..., 0]
            feat = self.feature(h)
            v = F.relu(self.views_0(torch.cat([feat, views_enc.to(dt)], dim=-1)))
            rgb = self.rgb(v)
        else:
            out = self.output(h)
            rgb, sigma = out[..., :3], out[..., 3]
        return rgb.float(), sigma.float()
