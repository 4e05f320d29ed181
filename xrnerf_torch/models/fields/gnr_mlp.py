"""GNR MLP — port of ``xrnerf_tpu/models/fields/gnr_mlp.py``: density and
colour over pixel-aligned multi-view features, with attention blending of
the source views' colours.

- an alpha trunk over per-view rows, pooled over the views (mean) at the
  first skip, with the point embedding concatenated at every skip;
- an rgb branch from the view-weighted pooled trunk and the SH-embedded
  query direction;
- key / value attention over (self + V) colour candidates, its softmax
  weighted by the SMPL visibility (or the occlusion net);
- the optional Pluecker-coordinate occlusion net.

Inputs are structured ([P, 3] points, [P, V, F] view features); the view
axis folds into the batch of every ``nn.Linear``, as the JAX field folds it
for the MXU. The layers keep flax's names (``alpha0..``, ``alpha_out``,
``rgb0..2``, ``rgb_out``, ``value0..2``, ``key0..2``, ``occ0..2`` and the
bare ``s``), so ``utils/weights.py`` carries a flax tree across. flax
infers input widths; here they come from the constructor: ``feat_dim``
(F, the encoder's channels + 3 source rgb) and ``smpl_dim`` (3 for the
T-pose, 4 for the SMPL SDF). ``nn.Linear`` in ``dtype`` (f32 by default);
sigma, rgb, the attention logits and the occlusion come out f32.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...registry import FIELDS
from ...utils.dtype import Dense, resolve_dtype
from ..embedders.gnr_embedder import gnr_posenc, gnr_posenc_dim, gnr_posenc_freqs, spherical_harmonics
from .nerf_mlp import flax_init_


def weighted_softmax(att: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis with entries 1: scaled by ``weight``
    (entry 0, the model's own rgb, is never down-weighted)."""
    e = torch.exp(att - att.max(-1, keepdim=True).values)
    e = torch.cat([e[..., :1], e[..., 1:] * weight], -1)
    return e / (e.sum(-1, keepdim=True) + 1e-8)


@FIELDS.register
class GNRMLP(nn.Module):
    """``dtype`` is flax's compute dtype of the ``Dense`` layers (the JAX
    field ``xrnerf_tpu/models/fields/gnr_mlp.py:56``); the outputs are cast
    back to f32 where JAX casts them (``:116``, ``:132``, ``:155``,
    ``:182``)."""

    def __init__(
        self,
        depth: int = 8,
        width: int = 256,
        skips: Sequence[int] = (2, 4, 6),
        num_views: int = 4,
        pose_freqs: int = 10,
        att_freqs: int = 6,
        spatial_freq: float = 1.0 / 256.0,
        use_smpl_sdf: bool = True,
        use_t_pose: bool = True,
        use_attention: bool = True,
        weighted_pool: bool = True,
        use_viewdirs: bool = True,
        use_sh: bool = True,
        use_occlusion_net: bool = False,
        angle_diff: bool = False,
        feat_dim: int = 259,
        smpl_dim: Optional[int] = None,
        dtype=torch.float32,
    ):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.depth, self.width, self.skips = depth, width, tuple(skips)
        self.use_attention, self.weighted_pool, self.use_viewdirs = use_attention, weighted_pool, use_viewdirs
        self.use_sh, self.angle_diff, self.use_occlusion_net = use_sh, angle_diff, use_occlusion_net
        # linear bands scaled by spatial_freq (the reference's gnr_mlp.py:56-59)
        self.register_buffer("pose_bands", torch.from_numpy(
            gnr_posenc_freqs(pose_freqs, spatial_freq * 0.1, spatial_freq * 10)), persistent=False)
        self.register_buffer("att_bands", torch.from_numpy(gnr_posenc_freqs(att_freqs)), persistent=False)
        if smpl_dim is None:
            smpl_dim = 3 * use_t_pose + 4 * use_smpl_sdf
        W, E, S = width, gnr_posenc_dim(3, pose_freqs), smpl_dim
        A = 9 if (use_sh and not angle_diff) else gnr_posenc_dim(3, att_freqs)
        base = E + S
        if use_occlusion_net:
            self.occ0 = Dense(S + 6 + feat_dim, W // 4, dtype=self.dtype)
            self.occ1 = Dense(W // 4, W // 16, dtype=self.dtype)
            self.occ2 = Dense(S + 6 + W // 16, 1, dtype=self.dtype)
        din = base + feat_dim
        for i in range(depth):
            setattr(self, f"alpha{i}", Dense(din, W, dtype=self.dtype))
            din = base + W if i in self.skips else W
        self.alpha_out = Dense(din, 1, dtype=self.dtype)
        if use_attention and weighted_pool:
            self.s = nn.Parameter(torch.ones(1))
        self.rgb0 = Dense(base + W, W // 4, dtype=self.dtype)
        self.rgb1 = Dense((A if use_viewdirs and use_attention else 0) + W // 4, W // 8, dtype=self.dtype)
        self.rgb2 = Dense(W // 8, W // 16, dtype=self.dtype)
        self.rgb_out = Dense(W // 16, 3, dtype=self.dtype)
        if use_attention:
            for name in ("value", "key"):
                setattr(self, f"{name}0", Dense(E + A + W, W // 4, dtype=self.dtype))
                setattr(self, f"{name}1", Dense(A + W // 4, W // 8, dtype=self.dtype))
                setattr(self, f"{name}2", Dense(A + W // 8, W // 16, dtype=self.dtype))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        flax_init_(self, generator)
        if hasattr(self, "s"):
            with torch.no_grad():
                self.s.fill_(1.0)

    def _att_embed(self, d: torch.Tensor) -> torch.Tensor:
        if self.use_sh and not self.angle_diff:
            return spherical_harmonics(d, rank=3)
        return gnr_posenc(d, self.att_bands)

    def forward(
        self,
        pts: torch.Tensor,  # [P, 3] normalised body coords
        view_feats: torch.Tensor,  # [P, V, F] pixel-aligned features (+ source rgb)
        smpl_feat: Optional[torch.Tensor] = None,  # [P, S]
        attdirs: Optional[torch.Tensor] = None,  # [P, V + 1, 3], the query first
        smpl_vis: Optional[torch.Tensor] = None,  # [P, V]
        alpha_only: bool = False,
    ) -> Dict[str, torch.Tensor]:
        P, V = view_feats.shape[:2]
        dt = self.dtype

        smpl = smpl_feat if smpl_feat is not None else view_feats.new_zeros((P, 0))
        pe_pts = gnr_posenc(pts, self.pose_bands).to(dt)  # [P, E]
        base = torch.cat([pe_pts, smpl.to(dt)], -1)
        base_v = base[:, None].expand(P, V, base.shape[-1])
        use_att = self.use_attention and attdirs is not None
        if use_att:
            qrydirs, srcdirs = attdirs[:, :1], attdirs[:, 1:]

        occ = None
        if self.use_occlusion_net and attdirs is not None:
            d = srcdirs
            m = torch.cross(pts[:, None].expand(d.shape), d, dim=-1)
            oh = torch.cat([base_v[..., pe_pts.shape[-1]:], d, m, view_feats], -1).to(dt)
            oin = torch.cat([smpl[:, None].expand(P, V, smpl.shape[-1]), d, m], -1).to(dt)
            oh = F.relu(self.occ1(F.relu(self.occ0(oh))))
            occ = torch.sigmoid(self.occ2(torch.cat([oin, oh], -1))[..., 0].float())  # [P, V]

        # alpha trunk over per-view rows, pooled over the views at skips[0]
        h = torch.cat([base_v, view_feats.to(dt)], -1)
        tmp_h, pooled = None, False
        for i in range(self.depth):
            h = F.relu(getattr(self, f"alpha{i}")(h))
            if i in self.skips:
                if not pooled:
                    tmp_h = h  # [P, V, W], the pre-pool trunk
                    h = h.mean(1)
                    pooled = True
                h = torch.cat([base, h], -1)
        sigma = self.alpha_out(h)[..., 0].float()
        if alpha_only:
            return {"sigma_raw": sigma}

        # rgb branch from the (view-weighted) pooled trunk
        if use_att and self.weighted_pool:
            w = torch.exp(self.s * ((srcdirs * qrydirs).sum(-1) - 1.0))  # [P, V]
            w = w / (w.sum(-1, keepdim=True) + 1e-8)
            h0 = (tmp_h * w[..., None].to(dt)).sum(1)
        else:
            h0 = tmp_h.mean(1)
        h = F.relu(self.rgb0(torch.cat([base, h0], -1)))
        if self.use_viewdirs and use_att:
            h = torch.cat([self._att_embed(-qrydirs[:, 0]).to(dt), h], -1)
        h = F.relu(self.rgb2(F.relu(self.rgb1(h))))
        out = {"rgb_raw": self.rgb_out(h).float(), "sigma_raw": sigma}

        # key / value attention over (self + V) colour candidates
        if use_att:
            att_e = self._att_embed(attdirs).to(dt)  # [P, V + 1, A]
            pts_all = pe_pts[:, None].expand(P, V + 1, pe_pts.shape[-1])
            val = torch.cat([pts_all, att_e, torch.cat([h0[:, None], tmp_h], 1)], -1)
            for i in range(3):
                val = getattr(self, f"value{i}")(val)
                if i < 2:
                    val = torch.cat([att_e, F.relu(val)], -1)
            q_e = self._att_embed(qrydirs[:, 0]).to(dt)
            key = torch.cat([pe_pts, q_e, h0], -1)
            for i in range(3):
                key = getattr(self, f"key{i}")(key)
                if i < 2:
                    key = torch.cat([q_e, F.relu(key)], -1)
            att = torch.einsum("pvc,pc->pv", val, key).float()
            if occ is not None:
                att = weighted_softmax(att, occ)
            elif smpl_vis is not None:
                att = weighted_softmax(att, smpl_vis.float())
            else:
                att = torch.softmax(att, -1)
            out["att"] = att  # [P, V + 1]
        if occ is not None:
            out["occ"] = occ
        return out
