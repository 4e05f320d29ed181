"""Vanilla NeRF MLP field — port of ``xrnerf_tpu/models/fields/nerf_mlp.py``.

8x256 trunk with the input skip-concat ``[x, h]`` after layer 4, separate
alpha/feature heads and a width/2 view-conditioned rgb head. Parameter
names match the flax tree (``pts_0..7``, ``alpha``, ``feature``,
``views_0``, ``rgb``; ``output`` without view dirs), so a flax checkpoint
maps one-to-one through ``utils/weights.py``.

``fused=False`` runs ``nn.Linear`` in f32. ``fused=True`` needs the
reference topology (netdepth 8, skip at 4, view dirs) and routes the whole
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

# flax lecun_normal: truncated normal on [-2, 2] std, rescaled so the
# variance is 1/fan_in (jax.nn.initializers.variance_scaling).
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(linear: nn.Linear, generator: Optional[torch.Generator]) -> None:
    """flax ``Dense`` init: lecun-normal (truncated) kernel, zero bias."""
    std = math.sqrt(1.0 / linear.in_features) / _TRUNC_STD
    w = torch.empty(linear.weight.shape, dtype=torch.float32)
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    with torch.no_grad():
        linear.weight.copy_(w)
        linear.bias.zero_()


class NerfMLP(nn.Module):
    def __init__(
        self,
        in_ch: int = 63,
        in_ch_views: int = 27,
        netdepth: int = 8,
        netwidth: int = 256,
        skips: Sequence[int] = (4,),
        use_viewdirs: bool = True,
        fused: bool = False,
    ):
        super().__init__()
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
            setattr(self, f"pts_{i}", nn.Linear(din, w))
        if use_viewdirs:
            self.alpha = nn.Linear(w, 1)
            self.feature = nn.Linear(w, w)
            self.views_0 = nn.Linear(w + in_ch_views, w // 2)
            self.rgb = nn.Linear(w // 2, 3)
        else:
            self.output = nn.Linear(w, 4)
        self._pack_key = None
        self._pack = None

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m, generator)

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
        x = pts_enc.float()
        h = x
        for i in range(self.netdepth):
            h = F.relu(getattr(self, f"pts_{i}")(h))
            if i in self.skips and i != self.netdepth - 1:
                h = torch.cat([x, h], dim=-1)
        if self.use_viewdirs:
            sigma = self.alpha(h)[..., 0]
            feat = self.feature(h)
            v = F.relu(self.views_0(torch.cat([feat, views_enc.float()], dim=-1)))
            rgb = self.rgb(v)
        else:
            out = self.output(h)
            rgb, sigma = out[..., :3], out[..., 3]
        return rgb, sigma
