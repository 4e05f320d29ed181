"""Animatable NeRF — port of ``xrnerf_tpu/models/networks/aninerf.py``:
posed sample points -> the nearest SMPL vertex's blend weights and
distance (``utils/lbs.py``), the SMPL-proximity filter (density -1e3 past
``smpl_dist_threshold``), a neural blend-weight field (``BlendWeightMLP``:
``normalize(smpl_bw * exp(mlp))``) and linear blend skinning to the
canonical pose, then the canonical density and colour fields
(``TPoseHuman``) and ``volume_render``.

Two phases. ``train_pose``: image MSE plus, in training, the smooth-L1
consistency of the posed blend weights with the canonical field's
(``tpose_bw_mlp``) on body points. ``novel_pose``: the novel-pose field
replaces the posed one, the loss is the consistency term alone, and
``trainable_filter`` gives the Trainer ``"novel_pose_bw_mlp" in name``, so
only that field trains. All four fields are built in either phase, so a
``train_pose`` state dict loads into a ``novel_pose`` network.

The batch's context: ``ctx_verts``, ``ctx_A`` [J, 4, 4], ``ctx_bw_verts``
[V, J], ``ctx_frame_idx``. f32 ``nn.Linear`` with flax's names: the JAX
fields are plain ``nn.Dense`` and reach no Pallas kernel.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...parallel.mesh import reduce_from
from ...registry import NETWORKS
from ...utils.metrics import img2mse, mse2psnr
from ..embedders.posenc import posenc, posenc_channels
from ..fields.nb_mlp import frame_code
from ..fields.nerf_mlp import flax_init_
from ..renders.volume import volume_render
from ..samplers.stratified import sample_along_rays, z_to_pts
from .utils.lbs import pose_to_tpose, sample_blend_weights


class BlendWeightMLP(nn.Module):
    """Residual blend-weight field: posed points and the frame's latent code
    -> J logits; the blend weights are ``normalize(smpl_bw * exp(logits))``."""

    def __init__(self, n_joints: int = 24, num_frames: int = 1000, latent_dim: int = 128, hidden: int = 256,
                 depth: int = 4, multires: int = 6):
        super().__init__()
        self.depth, self.multires = depth, multires
        self.latent = nn.Embedding(num_frames, latent_dim)
        din = posenc_channels(3, multires) + latent_dim
        for i in range(depth):
            setattr(self, f"fc{i}", nn.Linear(din if i == 0 else hidden, hidden))
        self.bw_out = nn.Linear(hidden, n_joints)

    def forward(self, pts, smpl_bw, frame_idx):
        latent = frame_code(self.latent, frame_idx, pts.shape[0])
        h = torch.cat([posenc(pts, self.multires), latent], -1)
        for i in range(self.depth):
            h = F.relu(getattr(self, f"fc{i}")(h))
        bw = smpl_bw * torch.exp(self.bw_out(h))
        return bw / torch.clamp(torch.sum(bw, -1, keepdim=True), min=1e-8)


class TPoseHuman(nn.Module):
    """Canonical-space density and colour fields."""

    def __init__(self, num_frames: int = 1000, color_latent_dim: int = 128, hidden: int = 256, depth: int = 4,
                 multires: int = 6):
        super().__init__()
        self.depth, self.multires = depth, multires
        for i in range(depth):
            setattr(self, f"density_fc{i}", nn.Linear(posenc_channels(3, multires) if i == 0 else hidden, hidden))
        self.density_out = nn.Linear(hidden, 1)
        self.feature = nn.Linear(hidden, hidden)
        self.color_latent = nn.Embedding(num_frames, color_latent_dim)
        self.color_fc = nn.Linear(hidden + color_latent_dim + posenc_channels(3, 4), hidden // 2)
        self.rgb = nn.Linear(hidden // 2, 3)

    def forward(self, tpts, viewdirs, frame_idx):
        h = posenc(tpts, self.multires)
        for i in range(self.depth):
            h = F.relu(getattr(self, f"density_fc{i}")(h))
        sigma = self.density_out(h)[..., 0]
        latent = frame_code(self.color_latent, frame_idx, tpts.shape[0])
        c = torch.cat([self.feature(h), latent, posenc(viewdirs, 4)], -1)
        rgb = self.rgb(F.relu(self.color_fc(c)))
        return rgb, sigma


@NETWORKS.register
class AniNeRFNetwork(nn.Module):
    def __init__(
        self,
        n_joints: int = 24,
        num_frames: int = 1000,
        n_samples: int = 64,
        hidden: int = 256,
        smpl_dist_threshold: float = 0.08,
        bw_consistency_weight: float = 1.0,
        phase: str = "train_pose",  # or "novel_pose"
        white_bkgd: bool = False,
    ):
        super().__init__()
        if phase not in ("train_pose", "novel_pose"):
            raise ValueError(f"unknown AniNeRF phase {phase!r}")
        self.n_samples, self.smpl_dist_threshold = n_samples, smpl_dist_threshold
        self.bw_consistency_weight, self.phase, self.white_bkgd = bw_consistency_weight, phase, white_bkgd
        self.pose_bw_mlp = BlendWeightMLP(n_joints=n_joints, num_frames=num_frames)
        self.novel_pose_bw_mlp = BlendWeightMLP(n_joints=n_joints, num_frames=num_frames)
        self.tpose_bw_mlp = BlendWeightMLP(n_joints=n_joints, num_frames=1)
        self.tpose_human = TPoseHuman(num_frames=num_frames, hidden=hidden)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's ``Dense`` and ``Embed`` initialisations."""
        flax_init_(self, generator)

    def trainable_filter(self):
        """``novel_pose``: only the novel-pose blend-weight field trains
        (a predicate on dotted parameter names); ``None`` otherwise."""
        if self.phase != "novel_pose":
            return None
        return lambda name: "novel_pose_bw_mlp" in name

    def forward(
        self,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        train: bool = False,
    ) -> Dict[str, torch.Tensor]:
        if train:
            return self._forward(batch, generator, train=True)
        with torch.inference_mode():
            return self._forward(batch, None, train=False)

    def _forward(self, batch, generator, train: bool) -> Dict[str, torch.Tensor]:
        rays_o, rays_d = batch["rays_o"], batch["rays_d"]
        frame_idx = batch["ctx_frame_idx"]
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        z_vals = sample_along_rays(batch["near"], batch["far"], self.n_samples, perturb=train, generator=generator)
        pts = z_to_pts(rays_o, rays_d, z_vals)
        n, s, _ = pts.shape
        flat = pts.reshape(n * s, 3)

        # SMPL-proximity filter and the initial blend weights (nearest vertex)
        smpl_bw, dist = sample_blend_weights(flat, batch["ctx_verts"], batch["ctx_bw_verts"])
        near_body = dist < self.smpl_dist_threshold
        bw_mlp = self.novel_pose_bw_mlp if self.phase == "novel_pose" else self.pose_bw_mlp
        pbw = bw_mlp(flat, smpl_bw + 1e-9, frame_idx)
        tpts = pose_to_tpose(flat, pbw, batch["ctx_A"])

        dirs_flat = viewdirs[:, None].expand(n, s, 3).reshape(n * s, 3)
        raw_rgb, raw_sigma = self.tpose_human(tpts, dirs_flat, frame_idx)
        raw_sigma = torch.where(near_body, raw_sigma, -1e3)
        ret = volume_render(raw_rgb.reshape(n, s, 3), raw_sigma.reshape(n, s), z_vals, rays_d,
                            white_bkgd=self.white_bkgd)
        out = {k: ret[k] for k in ("rgb", "acc", "depth", "disp")}

        if train:
            # blend-weight consistency: pbw(x) against tbw(T(x)) on body points
            tbw = self.tpose_bw_mlp(tpts, smpl_bw + 1e-9, torch.zeros_like(frame_idx))
            mask = near_body.to(torch.float32)[:, None]
            diff = torch.abs(pbw - tbw) * mask
            sl1 = torch.where(diff < 1.0, 0.5 * diff**2, diff - 0.5)  # smooth-L1 (Huber, delta 1)
            # over a data-sharded batch the denominator is the global batch's (detached, clamped after the
            # sum), so that the ranks' shares add up to the one-process value
            denom = torch.sum(mask)
            rows = getattr(generator, "rows", None)
            if rows is not None and rows.group is not None:
                denom = reduce_from(denom.detach(), rows.group)
            out["bw_consistency"] = torch.sum(sl1) / torch.clamp(denom, min=1.0)
        return out

    def loss(
        self, outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        mse = img2mse(outputs["rgb"], batch["target"])
        loss = mse
        log = {"mse": mse, "psnr": mse2psnr(mse)}
        if "bw_consistency" in outputs:
            loss = loss + self.bw_consistency_weight * outputs["bw_consistency"]
            log["bw_consistency"] = outputs["bw_consistency"]
        if self.phase == "novel_pose":
            # only the blend-weight consistency drives novel-pose training
            loss = outputs.get("bw_consistency", loss)
        log["loss"] = loss
        return loss, log
