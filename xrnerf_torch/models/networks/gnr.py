"""GNR, the generalizable neural human radiance field — port of
``xrnerf_tpu/models/networks/gnr.py``.

A stacked-hourglass encoder (optionally a feature up-sampler) turns the
frame's source views into pixel-aligned features; each sample point gets
them by projection, plus a body-shape embedding from SMPL queries (the
nearest face's T-pose position, and the signed, normalised offset to the
surface), and ``GNRMLP`` gives density, colour and attention over the
source views' colours. Samples outside the visual hull get sigma = -1e4.
The loss is the nerf-rgb MSE plus the attention-blend MSE.

Batch layout, as in the JAX network: ray segments ``rays_s`` / ``rays_e``,
and the frame's context in ``ctx_*`` keys (source images, masks, calibs,
perspective params, SMPL mesh, T-pose vertices, rotation, centre, scale),
whole in every chunk. The encoder runs on every call, once per eval chunk
too, as the JAX network does.

- With ``train_encoder=False`` the encoder runs under ``torch.no_grad()``:
  its activations stay out of autograd and its parameters get no gradient
  (the JAX network's ``stop_gradient``; Adam on zero gradients leaves them
  as they are, as on no gradient).
- Randomness: the ``torch.Generator`` passed to ``forward`` draws, in
  training, the sample jitter and then the N(0, 1) density noise; eval runs
  under ``torch.inference_mode()``. ``train=True`` without a generator is
  the deterministic path with gradients.
- The SMPL queries (``ops/mesh.py``) take no part in autograd.
- ``dtype`` (f32 by default) is the encoders' and the MLP's compute dtype;
  the features are sampled in f32 from the encoder's ``dtype`` values, as
  JAX's bilinear taps promote them; the SMPL queries, sampling and
  compositing stay f32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ...ops.mesh import inside_mesh, nearest_points
from ...registry import NETWORKS
from ...utils.metrics import img2mse, mse2psnr
from ..embedders.gnr_embedder import HGFilter, SRFilters
from ..fields.gnr_mlp import GNRMLP
from ..renders.gnr_render import (
    composite_gnr,
    index_views,
    orthogonal_project,
    perspective_project,
    sample_segment,
    smpl_visibility,
    visual_hull_mask,
)


@NETWORKS.register
class GnrNetwork(nn.Module):
    """``dtype``: the JAX field ``xrnerf_tpu/models/networks/gnr.py:71``,
    passed on to ``HGFilter`` (``:78``), ``SRFilters`` (``:82``) and
    ``GNRMLP`` (``:93``)."""

    def __init__(
        self,
        num_views: int = 4,
        n_samples: int = 256,
        load_size: int = 512,
        projection_mode: str = "perspective",  # or "orthogonal"
        use_feat_sr: bool = False,
        use_smpl_sdf: bool = True,
        use_t_pose: bool = True,
        use_smpl_depth: bool = True,
        use_nml: bool = True,
        use_attention: bool = True,
        use_occlusion: bool = True,
        use_occlusion_net: bool = False,
        use_vh: bool = True,
        vh_compact_frac: float = 0.0,  # > 0: evaluate only this share of the points, hull hits first
        use_white_bkgd: bool = False,
        use_viewdirs: bool = True,
        train_encoder: bool = False,
        num_stack: int = 4,
        num_hourglass: int = 2,
        hourglass_dim: int = 256,
        mlp_depth: int = 8,
        mlp_width: int = 256,
        skips: Any = (2, 4, 6),
        mesh_chunk: int = 2048,
        dtype=torch.float32,
    ):
        super().__init__()
        self.num_views, self.n_samples, self.load_size = num_views, n_samples, load_size
        self.projection_mode, self.use_feat_sr = projection_mode, use_feat_sr
        self.use_smpl_sdf, self.use_t_pose, self.use_smpl_depth = use_smpl_sdf, use_t_pose, use_smpl_depth
        self.use_nml, self.use_attention, self.use_occlusion = use_nml, use_attention, use_occlusion
        self.use_vh, self.vh_compact_frac, self.use_white_bkgd = use_vh, vh_compact_frac, use_white_bkgd
        self.train_encoder, self.mesh_chunk = train_encoder, mesh_chunk
        self.image_filter = HGFilter(num_stack=num_stack, num_hourglass=num_hourglass, hourglass_dim=hourglass_dim,
                                     dtype=dtype)
        feat_dim = 64 if use_feat_sr else hourglass_dim
        if use_feat_sr:
            self.sr_filter = SRFilters(order=2, out_ch=feat_dim, in_ch=hourglass_dim, dtype=dtype)
        self.nerf = GNRMLP(depth=mlp_depth, width=mlp_width, skips=tuple(skips), num_views=num_views,
                           use_smpl_sdf=use_smpl_sdf, use_t_pose=use_t_pose, use_attention=use_attention,
                           use_viewdirs=use_viewdirs, use_occlusion_net=use_occlusion_net, feat_dim=feat_dim + 3,
                           dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.image_filter.reset_parameters(generator)
        if self.use_feat_sr:
            self.sr_filter.reset_parameters(generator)
        self.nerf.reset_parameters(generator)

    # ------------------------------------------------------------------
    def encode_images(self, images: torch.Tensor) -> torch.Tensor:
        """[V, H, W, 3] -> [V, F, h, w] pixel-aligned features (NCHW)."""
        x = images.permute(0, 3, 1, 2)
        if self.train_encoder:
            feats = self.image_filter(x)
        else:
            with torch.no_grad():
                feats = self.image_filter(x)
        if self.use_feat_sr:
            feats = self.sr_filter(feats, x)
        return feats

    def _project_uv(self, pts, calibs, persps):
        if self.projection_mode == "perspective" and persps is not None:
            xyz = perspective_project(pts, calibs, persps)
            return xyz[..., :2] / self.load_size * 2.0 - 1.0
        return orthogonal_project(pts, calibs)[..., :2]

    def field(
        self,
        batch: Dict[str, torch.Tensor],
        feats: torch.Tensor,  # [V, F, h, w] encoded source features
        flat: torch.Tensor,  # [P, 3] world points
        viewdirs: Optional[torch.Tensor] = None,  # [P, 3] query ray directions
        alpha_only: bool = False,
    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, Optional[torch.Tensor]]:
        """Point-level field query, shared by rendering and reconstruction:
        -> (GNRMLP outputs, source rgb [V, P, 3], keep [P] or None)."""
        V = self.num_views
        src_images = batch["ctx_images"][:V].permute(0, 3, 1, 2)
        src_calibs = batch["ctx_calibs"][:V]
        persps = batch.get("ctx_persps")
        src_persps = persps[:V] if persps is not None else None
        center, spatial_freq = batch["ctx_center"], batch["ctx_spatial_freq"]
        rot = batch.get("ctx_smpl_rot")
        P = flat.shape[0]

        keep = None
        if self.use_vh:
            keep = visual_hull_mask(flat, batch["ctx_masks"][:V], src_calibs, src_persps,
                                    self.load_size, self.load_size)

        # sort-compaction: a static budget of points, hull hits first; the
        # dropped points read back sigma = -1e4 like hull misses
        restore = None
        if keep is not None and 0.0 < self.vh_compact_frac < 1.0:
            budget = max(int(P * self.vh_compact_frac), 1)
            order = torch.argsort((~keep).to(torch.uint8), stable=True)
            sel = order[:budget]
            restore = (sel, P)
            flat, keep = flat[sel], keep[sel]
            if viewdirs is not None:
                viewdirs = viewdirs[sel]
            P = budget

        # attention directions: the query's first, then towards each source camera
        attdirs = None
        if self.use_attention and viewdirs is not None:
            c2w = torch.linalg.inv_ex(src_calibs)[0]  # no error check: no host sync
            if self.projection_mode == "perspective" and persps is not None:
                src_dirs = c2w[:, :3, 3][None] - flat[:, None]  # [P, V, 3]
            else:
                src_dirs = c2w[:, :3, 2][None].expand(P, V, 3)
            if rot is not None:
                viewdirs, src_dirs = viewdirs @ rot, src_dirs @ rot
            attdirs = torch.cat([viewdirs[:, None], src_dirs], 1)
            attdirs = attdirs / torch.clamp(torch.linalg.norm(attdirs, dim=-1, keepdim=True), min=1e-9)

        # body-shape embedding from the SMPL mesh
        half = self.load_size / 2.0
        pts_nml = (flat - center) * spatial_freq / half
        if self.use_smpl_sdf and rot is not None:
            pts_nml = pts_nml @ rot
        mlp_pts = pts_nml if self.use_nml else flat

        smpl_feat = None
        if self.use_smpl_sdf or self.use_t_pose:
            verts, faces = batch["ctx_smpl_verts"], batch["ctx_smpl_faces"].long()
            closest, fidx, _ = nearest_points(flat, verts, faces, chunk=self.mesh_chunk)
            pieces = []
            if self.use_t_pose:
                pieces.append(batch["ctx_smpl_t_verts"][faces[fidx.long()]].mean(1))
            if self.use_smpl_sdf:
                reg = flat - closest
                if self.use_nml:
                    reg = reg * spatial_freq / half
                    if rot is not None:
                        reg = reg @ rot
                signs = inside_mesh(flat, verts, faces, chunk=self.mesh_chunk)
                norm_r = torch.linalg.norm(reg, dim=-1, keepdim=True) + 1e-8
                pieces += [reg / norm_r, torch.tanh(norm_r * signs[:, None] * 20.0)]
            smpl_feat = torch.cat(pieces, -1)

        # pixel-aligned multi-view features and source rgb
        uv = self._project_uv(flat, src_calibs, src_persps)
        latent = index_views(feats.float(), uv)  # [V, P, F]
        src_rgb = index_views(src_images, uv)  # [V, P, 3]
        view_feats = torch.cat([latent, src_rgb], -1).transpose(0, 1)

        smpl_vis = None
        if self.use_occlusion and self.use_smpl_depth and "ctx_smpl_depth" in batch:
            smpl_vis = smpl_visibility(flat, batch["ctx_smpl_depth"], src_calibs, src_persps,
                                       self.load_size, self.load_size)

        mlp_out = self.nerf(mlp_pts, view_feats, smpl_feat=smpl_feat, attdirs=attdirs, smpl_vis=smpl_vis,
                            alpha_only=alpha_only)
        if restore is not None:
            sel, full_p = restore

            def scatter(x, fill=0.0):
                return torch.full((full_p,) + x.shape[1:], fill, dtype=x.dtype, device=x.device).index_copy(0, sel, x)

            mlp_out = {k: scatter(v, -1e4 if k == "sigma_raw" else 0.0) for k, v in mlp_out.items()}
            src_rgb = scatter(src_rgb.transpose(0, 1)).transpose(0, 1)
            keep = scatter(keep.float()) > 0.5
        return mlp_out, src_rgb, keep

    def query_density(self, batch, pts: torch.Tensor) -> torch.Tensor:
        """Hull-masked occupancy in [0, 1] at world points, sigmoid(sigma)."""
        feats = self.encode_images(batch["ctx_images"][: self.num_views])
        mlp_out, _, keep = self.field(batch, feats, pts, None, alpha_only=True)
        sigma = mlp_out["sigma_raw"]
        if keep is not None:
            sigma = torch.where(keep, sigma, -1e4)
        return torch.sigmoid(sigma)

    def query_color(self, batch, pts: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
        """Attention-blended colour at surface points; the normals serve as
        the query directions."""
        feats = self.encode_images(batch["ctx_images"][: self.num_views])
        mlp_out, src_rgb, _ = self.field(batch, feats, pts, normals)
        rgb = torch.sigmoid(mlp_out["rgb_raw"])
        if "att" in mlp_out:
            cand = torch.cat([rgb[:, None], src_rgb.transpose(0, 1)], 1)  # [P, V + 1, 3]
            rgb = (cand * mlp_out["att"][..., None]).sum(1)
        return rgb

    # ------------------------------------------------------------------
    def forward(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                train: bool = False) -> Dict[str, torch.Tensor]:
        if train:
            return self._forward(batch, generator)
        with torch.inference_mode():
            return self._forward(batch, None)

    def _forward(self, batch, generator) -> Dict[str, torch.Tensor]:
        rays_s, rays_e = batch["rays_s"], batch["rays_e"]
        persps = batch.get("ctx_persps")
        V = self.num_views
        feats = self.encode_images(batch["ctx_images"][:V])

        pts, t_vals = sample_segment(rays_s, rays_e, self.n_samples, generator)
        R, S = pts.shape[:2]
        flat = pts.reshape(R * S, 3)
        viewdirs = (rays_s - rays_e)[:, None].expand(R, S, 3).reshape(R * S, 3)

        mlp_out, src_rgb, keep = self.field(batch, feats, flat, viewdirs)
        sigma = mlp_out["sigma_raw"]
        if keep is not None:
            sigma = torch.where(keep, sigma, -1e4)
        norm = torch.linalg.norm(rays_e - rays_s, dim=-1, keepdim=True)
        if self.use_nml:
            norm = norm * batch["ctx_spatial_freq"] / (self.load_size / 2.0)
        att = mlp_out["att"].reshape(R, S, -1) if "att" in mlp_out else None
        ret = composite_gnr(mlp_out["rgb_raw"].reshape(R, S, 3), sigma.reshape(R, S), t_vals, norm,
                            generator=generator, att=att,
                            source_rgb=src_rgb.transpose(0, 1).reshape(R, S, V, 3), white_bkgd=self.use_white_bkgd)
        # depth in the query camera's metric range when there is one;
        # fma(t, far, fl((1 - t) near)), as XLA contracts t * far + (1 - t) * near
        if persps is not None:
            z_vals = torch.addcmul((1 - t_vals) * persps[-1, -2], t_vals, persps[-1, -1])
        else:
            z_vals = 2 * t_vals - 1
        depth = (ret["weights"] * z_vals).sum(-1)
        out = {"rgb": ret.get("att_rgb", ret["rgb"]), "nerf_rgb": ret["rgb"], "acc": ret["acc"],
               "depth": depth, "disp": depth}
        if "att_rgb" in ret:
            out["att_rgb"] = ret["att_rgb"]
        return out

    def loss(self, outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]):
        target = batch["target"]
        nerf_mse = img2mse(outputs["nerf_rgb"], target)
        loss, log = nerf_mse, {"nerf_mse": nerf_mse}
        if "att_rgb" in outputs:
            att_mse = img2mse(outputs["att_rgb"], target)
            loss = loss + att_mse
            log.update(att_mse=att_mse, psnr=mse2psnr(att_mse))
        else:
            log["psnr"] = mse2psnr(nerf_mse)
        log["loss"] = loss
        return loss, log
