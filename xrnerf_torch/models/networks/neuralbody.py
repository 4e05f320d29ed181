"""NeuralBody network — port of ``xrnerf_tpu/models/networks/neuralbody.py``:
stratified samples between the person box's near and far, the SMPL
latent-code volume (``SmplEmbedder``) sampled at the points, the NB head
(``NBNerfMLP``) over those features, the frame's appearance code and the
points normalised to the box; density forced to -1e3 outside the box;
``volume_render``. The loss is the image MSE, with ``acc_err`` logged when
the batch carries a ``mask``.

The batch's context (``ctx_verts`` posed vertices, ``ctx_frame_idx``,
``ctx_bmin`` / ``ctx_bmax``) is whole in every chunk, and the volume is
rebuilt from it on every call, once per eval chunk too, as in JAX.
Randomness: the ``torch.Generator`` passed to ``forward`` jitters the
samples in training; eval runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ...registry import NETWORKS
from ...utils.metrics import img2mse, mse2psnr
from ..embedders.neuralbody import SmplEmbedder
from ..fields.nb_mlp import NBNerfMLP
from ..renders.volume import volume_render
from ..samplers.stratified import sample_along_rays, z_to_pts


@NETWORKS.register
class NeuralBodyNetwork(nn.Module):
    """``dtype``: the embedder's and the head's compute dtype (the JAX field
    ``xrnerf_tpu/models/networks/neuralbody.py:38``, passed on at ``:46`` and
    ``:52``)."""

    def __init__(
        self,
        n_verts: int = 6890,
        code_dim: int = 16,
        grid_dims: Tuple[int, int, int] = (96, 96, 96),
        conv_widths: Tuple[int, ...] = (32, 32, 32, 32),
        num_frames: int = 1000,
        appearance_dim: int = 128,
        hidden: int = 256,
        n_samples: int = 64,
        white_bkgd: bool = False,
        dtype=torch.float32,
    ):
        super().__init__()
        self.n_samples, self.white_bkgd = n_samples, white_bkgd
        self.embedder = SmplEmbedder(n_verts=n_verts, code_dim=code_dim, grid_dims=grid_dims, widths=conv_widths,
                                     dtype=dtype)
        self.mlp = NBNerfMLP(in_ch=sum(conv_widths), num_frames=num_frames, appearance_dim=appearance_dim,
                             hidden=hidden, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.embedder.reset_parameters(generator)
        self.mlp.reset_parameters(generator)

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
        bmin, bmax = batch["ctx_bmin"], batch["ctx_bmax"]
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        z_vals = sample_along_rays(batch["near"], batch["far"], self.n_samples, perturb=train, generator=generator)
        pts = z_to_pts(rays_o, rays_d, z_vals)  # [N, S, 3]
        n, s, _ = pts.shape
        flat = pts.reshape(n * s, 3)

        feats = self.embedder(batch["ctx_verts"], flat, bmin, bmax)
        rel = torch.clamp((flat - bmin) / torch.clamp(bmax - bmin, min=1e-6), 0.0, 1.0)
        dirs_flat = viewdirs[:, None].expand(n, s, 3).reshape(n * s, 3)
        raw_rgb, raw_sigma = self.mlp(feats, dirs_flat, rel * 2.0 - 1.0, batch["ctx_frame_idx"])
        # points outside the person box contribute nothing
        inb = torch.all((flat >= bmin) & (flat <= bmax), dim=-1)
        raw_sigma = torch.where(inb, raw_sigma, -1e3)

        ret = volume_render(raw_rgb.reshape(n, s, 3), raw_sigma.reshape(n, s), z_vals, rays_d,
                            white_bkgd=self.white_bkgd)
        return {k: ret[k] for k in ("rgb", "acc", "depth", "disp")}

    def loss(
        self, outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        mse = img2mse(outputs["rgb"], batch["target"])
        log = {"loss": mse, "mse": mse, "psnr": mse2psnr(mse)}
        if "mask" in batch:
            log["acc_err"] = img2mse(outputs["acc"][..., None], batch["mask"])
        return mse, log
