"""BungeeNeRF progressive MLP — port of
``xrnerf_tpu/models/fields/bungee_mlp.py``: an 8×256 base with the input
skip after layer 4, then per stage an (rgb, alpha) head and, from stage 1
on, a residual block conditioned on the input encoding. Every stage is
evaluated each call; the curriculum masks stages in the compositing and
loss. Layers keep the flax names (``base_i``, ``alpha_s*``,
``bottleneck_s*``, ``views_s*``, ``rgb_s*``, ``res_{s}_{j}``,
``res_proj_{s}``), so a flax tree maps one to one through
``utils/weights.py``. ``nn.Linear`` in ``dtype`` (f32 by default): the
JAX field runs plain ``nn.Dense`` and reaches no Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...utils.dtype import Dense, resolve_dtype
from .nerf_mlp import flax_init_


class BungeeNerfMLP(nn.Module):
    """``dtype`` is flax's compute dtype (the JAX field
    ``xrnerf_tpu/models/fields/bungee_mlp.py:28``; ``utils/dtype.py``): the
    encodings go in cast to it, raw rgb and sigma come out f32
    (``bungee_mlp.py:67-68``)."""

    def __init__(
        self,
        in_ch: int = 60,
        in_ch_views: int = 27,
        n_stages: int = 4,
        netdepth_base: int = 8,
        netwidth: int = 256,
        netdepth_res: int = 1,
        skips: Sequence[int] = (4,),
        dtype=torch.float32,
    ):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.n_stages, self.netdepth_base, self.netdepth_res = n_stages, netdepth_base, netdepth_res
        self.skips = tuple(skips)
        w = netwidth
        for i in range(netdepth_base):
            skip_in = i > 0 and (i - 1) in self.skips and (i - 1) != netdepth_base - 1
            setattr(self, f"base_{i}", Dense(in_ch if i == 0 else (in_ch + w if skip_in else w), w, dtype=self.dtype))
        for s in range(n_stages):
            if s > 0:
                for j in range(netdepth_res):
                    setattr(self, f"res_{s}_{j}", Dense(w + in_ch if j == 0 else w, w, dtype=self.dtype))
                setattr(self, f"res_proj_{s}", Dense(w, w, dtype=self.dtype))
            setattr(self, f"alpha_s{s}", Dense(w, 1, dtype=self.dtype))
            setattr(self, f"bottleneck_s{s}", Dense(w, w, dtype=self.dtype))
            setattr(self, f"views_s{s}", Dense(w + in_ch_views, w // 2, dtype=self.dtype))
            setattr(self, f"rgb_s{s}", Dense(w // 2, 3, dtype=self.dtype))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        flax_init_(self, generator)

    def _heads(self, feat, views_enc, s):
        sigma = getattr(self, f"alpha_s{s}")(feat)[..., 0]
        v = torch.cat([getattr(self, f"bottleneck_s{s}")(feat), views_enc], dim=-1)
        rgb = getattr(self, f"rgb_s{s}")(F.relu(getattr(self, f"views_s{s}")(v)))
        return rgb, sigma

    def forward(self, pts_enc: torch.Tensor, views_enc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (raw_rgb [N, stages, 3], raw_sigma [N, stages])."""
        x = pts_enc.to(self.dtype)
        views_enc = views_enc.to(self.dtype)
        h = x
        for i in range(self.netdepth_base):
            h = F.relu(getattr(self, f"base_{i}")(h))
            if i in self.skips and i != self.netdepth_base - 1:
                h = torch.cat([x, h], dim=-1)
        rgbs, sigmas = [], []
        for s in range(self.n_stages):
            if s > 0:  # residual block conditioned on the input encoding
                r = torch.cat([h, x], dim=-1)
                for j in range(self.netdepth_res):
                    r = F.relu(getattr(self, f"res_{s}_{j}")(r))
                h = h + getattr(self, f"res_proj_{s}")(r)
            rgb, sigma = self._heads(h, views_enc, s)
            rgbs.append(rgb)
            sigmas.append(sigma)
        return torch.stack(rgbs, dim=-2).float(), torch.stack(sigmas, dim=-1).float()
