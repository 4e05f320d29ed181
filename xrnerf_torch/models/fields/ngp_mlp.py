"""Instant-NGP field: hash encoding + tiny MLPs — port of
``xrnerf_tpu/models/fields/ngp_mlp.py``.

HashGrid (16 levels x 2 features, table 2^19) -> density MLP (64 wide, one
hidden layer, 1 + ``geo_feat_dim`` outputs) and SH(degree 4) + geo features
-> colour MLP (64 wide, two hidden layers, 3 outputs). ``hash_layout``
selects the encoding: ``'vertex'`` (tcnn's interpolation) or ``'brick'``
(one row per point, level and lattice; ``n_lattices``, ``brick_blend``). Two
parameter layouts, as in the JAX package:

- ``fused=False``: ``density_net`` (Linear-ReLU-Linear) and ``color_net``
  (three Linears) as ``nn.Sequential``s whose indices match flax's
  ``layers_{0,2}`` / ``layers_{0,2,4}``; parameters f32, computed in
  ``dtype`` (bf16) as flax ``Dense(dtype=bf16)`` does.
- ``fused=True`` (the JAX ``use_pallas=True`` layout): ``d_w1 .. c_b3``,
  weights stored [in, out] as flax stores them, through
  ``ops/fused_mlp.py`` (the CUDA kernels on the card, forward and backward,
  their plain versions on the CPU). The JAX rounding points are kept: the encoding, the geo
  features and the SH values are rounded to ``dtype`` and enter the fused
  MLPs as f32; raw sigma and raw rgb leave as f32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ...ops.fused_mlp import fused_mlp2, fused_mlp3
from ...utils.dtype import resolve_dtype
from ..embedders.hashenc import BrickHashEncoding, HashEncoding
from ..embedders.sh import sh_encode
from .nerf_mlp import _TRUNC_STD, lecun_normal_


class NGPField(nn.Module):
    def __init__(
        self,
        n_levels: int = 16,
        n_features: int = 2,
        log2_table_size: int = 19,
        base_res: int = 16,
        max_res: int = 2048,
        hidden_dim: int = 64,
        geo_feat_dim: int = 15,
        sh_degree: int = 4,
        fused: bool = False,
        hash_layout: str = "vertex",
        n_lattices: int = 1,  # brick only: 2 = staggered dual lattice
        brick_blend: str = "mean",  # brick only: 'smooth' = face-bump cross-fade
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.geo_feat_dim, self.sh_degree = geo_feat_dim, sh_degree
        self.fused, self.dtype = fused, resolve_dtype(dtype)
        enc_kw = dict(n_levels=n_levels, n_features=n_features, log2_table_size=log2_table_size,
                      base_res=base_res, max_res=max_res, dtype=dtype)
        if hash_layout == "brick":
            self.encoding = BrickHashEncoding(n_lattices=n_lattices, blend=brick_blend, **enc_kw)
        else:  # as the JAX field: anything else is the vertex layout
            self.encoding = HashEncoding(**enc_kw)
        enc_dim, sh_dim = n_levels * n_features, sh_degree**2
        h, g = hidden_dim, geo_feat_dim
        if fused:
            shapes = {"d_w1": (enc_dim, h), "d_w2": (h, 1 + g), "c_w1": (g + sh_dim, h), "c_w2": (h, h), "c_w3": (h, 3)}
            for name, (i, o) in shapes.items():
                setattr(self, name, nn.Parameter(torch.empty(i, o)))
                setattr(self, name.replace("w", "b"), nn.Parameter(torch.zeros(o)))
        else:
            self.density_net = nn.Sequential(nn.Linear(enc_dim, h), nn.ReLU(), nn.Linear(h, 1 + g))
            self.color_net = nn.Sequential(
                nn.Linear(g + sh_dim, h), nn.ReLU(), nn.Linear(h, h), nn.ReLU(), nn.Linear(h, 3)
            )
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's distributions: the table's uniform, truncated lecun-normal
        weights, zero biases."""
        self.encoding.reset_parameters(generator)
        if not self.fused:
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    lecun_normal_(m, generator)
            return
        with torch.no_grad():
            for name, p in self.named_parameters(recurse=False):
                if name[2] == "b":
                    p.zero_()
                    continue
                std = math.sqrt(1.0 / p.shape[0]) / _TRUNC_STD
                w = torch.empty(p.shape, dtype=torch.float32)
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
                p.copy_(w)

    def _net(self, net: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        """flax ``Dense(dtype)`` chain: input, kernel and bias cast to
        ``dtype``, the output in ``dtype``."""
        for m in net:
            if isinstance(m, nn.Linear):
                x = nn.functional.linear(x.to(self.dtype), m.weight.to(self.dtype), m.bias.to(self.dtype))
            else:
                x = m(x)
        return x

    def density(self, pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """pts [..., 3] in [0,1]^3 -> (raw_sigma [...] f32, geo_feat [..., G])."""
        enc = self.encoding(pts)
        if self.fused:
            lead = enc.shape[:-1]
            h = fused_mlp2(
                enc.reshape(-1, enc.shape[-1]).float(), self.d_w1, self.d_b1, self.d_w2, self.d_b2
            ).reshape(*lead, 1 + self.geo_feat_dim)
        else:
            h = self._net(self.density_net, enc)
        return h[..., 0].float(), h[..., 1:]

    def forward(self, pts: torch.Tensor, dirs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """pts [..., 3], unit dirs [..., 3] -> (raw_rgb [..., 3], raw_sigma [...])."""
        raw_sigma, geo = self.density(pts)
        sh = sh_encode(dirs, self.sh_degree).to(self.dtype)
        cin = torch.cat([geo.to(self.dtype), sh], dim=-1)
        if self.fused:
            lead = cin.shape[:-1]
            raw_rgb = fused_mlp3(
                cin.reshape(-1, cin.shape[-1]).float(),
                self.c_w1, self.c_b1, self.c_w2, self.c_b2, self.c_w3, self.c_b3,
            ).reshape(*lead, 3)
        else:
            raw_rgb = self._net(self.color_net, cin)
        return raw_rgb.float(), raw_sigma
