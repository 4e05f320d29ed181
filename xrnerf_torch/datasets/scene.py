"""Scene ray datasets (numpy) — port of ``xrnerf_tpu/datasets/scene.py``.

Rays are precomputed on the host and served as fixed-shape numpy batches;
the renderer moves them to the model's device. Layouts: ``blender``,
``llff`` (``bds``-derived near/far, or 0/1 in NDC), ``nsvf`` (its own
intrinsics, near/far and ``bbox``), ``deepvoxels`` (near/far from the mean
camera radius) and ``LINEMOD`` (per-frame intrinsics, meta near/far). The
loaders other than blender's are imported when their layout is asked for.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..registry import DATASETS
from .load.blender import load_blender_data
from .rays import flatten_image_rays, get_ray_radii, get_rays_np, intrinsics_from_hwf, ndc_rays


def apply_white_bkgd(imgs: np.ndarray) -> np.ndarray:
    """RGBA -> RGB composited over white."""
    if imgs.shape[-1] == 4:
        return imgs[..., :3] * imgs[..., 3:4] + (1.0 - imgs[..., 3:4])
    return imgs


@DATASETS.register
class SceneDataset:
    """Scene dataset serving ray batches.

    - train 'batching': pooled pre-shuffled rays over all train images
    - train 'no_batching': one random image per step, N_rand random pixels,
      with optional center precrop for early iters
    - val/test: full-image rays per index (``eval_item``), novel views
      (``spiral_item``)
    """

    def __init__(
        self,
        datadir: str,
        dataset_type: str = "blender",
        half_res: bool = False,
        testskip: int = 8,
        white_bkgd: bool = True,
        N_rand: int = 1024,
        batching: bool = False,
        precrop_iters: int = 0,
        precrop_frac: float = 0.5,
        use_ndc: bool = False,
        near: float = 2.0,
        far: float = 6.0,
        with_radii: bool = False,
        seed: int = 0,
    ):
        self.N_rand = int(N_rand)
        self.batching = batching
        self.precrop_iters = precrop_iters
        self.precrop_frac = precrop_frac
        self.use_ndc = use_ndc
        self.white_bkgd = white_bkgd
        self.with_radii = with_radii
        self.seed = seed

        K_override = None
        self.bbox = None  # (bmin, bmax) global domain when the layout has one
        if dataset_type == "blender":
            imgs, poses, render_poses, hwf, i_split = load_blender_data(
                datadir, half_res=half_res, testskip=testskip
            )
            self.near, self.far = float(near), float(far)
        elif dataset_type == "llff":
            from .load.llff import load_llff_data

            imgs, poses, bds, render_poses, i_split = load_llff_data(datadir)
            hwf = [int(poses[0, 0, -1]), int(poses[0, 1, -1]), poses[0, 2, -1]]
            poses = poses[:, :3, :4]
            if use_ndc:
                self.near, self.far = 0.0, 1.0
            else:
                self.near = float(np.min(bds)) * 0.9
                self.far = float(np.max(bds)) * 1.0
        elif dataset_type == "nsvf":
            from .load.nsvf import load_nsvf_data

            (imgs, poses, K_override, self.near, self.far, self.bbox, _bg,
             render_poses, i_split) = load_nsvf_data(datadir, testskip=testskip)
            hwf = [imgs.shape[1], imgs.shape[2], K_override[0, 0]]
        elif dataset_type == "deepvoxels":
            from .load.deepvoxels import load_deepvoxels_data

            imgs, poses, render_poses, hwf, (cx, cy), i_split = load_deepvoxels_data(datadir, testskip=testskip)
            K_override = np.array([[hwf[2], 0, cx], [0, hwf[2], cy], [0, 0, 1]], np.float32)
            hemi_r = float(np.mean(np.linalg.norm(poses[:, :3, -1], axis=-1)))
            self.near, self.far = hemi_r - 1.0, hemi_r + 1.0
        elif dataset_type == "LINEMOD":
            from .load.linemod import load_linemod_data

            (imgs, poses, render_poses, hwf, K_override, i_split,
             self.near, self.far) = load_linemod_data(datadir, half_res=half_res, testskip=testskip)
            K_override = np.asarray(K_override, np.float32)[:3, :3]
        else:
            raise ValueError(f"unknown dataset_type {dataset_type!r}")

        self.H, self.W = int(hwf[0]), int(hwf[1])
        self.focal = float(hwf[2])
        self.K = K_override if K_override is not None else intrinsics_from_hwf(self.H, self.W, self.focal)

        self.alphas = imgs[..., 3:4].copy() if imgs.shape[-1] == 4 else None
        imgs3 = apply_white_bkgd(imgs) if white_bkgd else imgs[..., :3]
        self.imgs = imgs3.astype(np.float32)
        self.poses = poses.astype(np.float32)
        self.render_poses = render_poses.astype(np.float32)
        self.i_train, self.i_val, self.i_test = [np.asarray(s) for s in i_split]

        self._pool: Optional[Dict[str, np.ndarray]] = None
        self._perm: Optional[np.ndarray] = None
        if batching:
            self._build_pool()

    # ------------------------------------------------------------------
    def _build_pool(self):
        tr = self.i_train
        pool = flatten_image_rays(self.imgs[tr], self.poses[tr], self.H, self.W, self.K)
        if self.use_ndc:
            pool["rays_o"], pool["rays_d"] = ndc_rays(
                self.H, self.W, self.focal, 1.0, pool["rays_o"], pool["rays_d"]
            )
        self._pool = pool
        n = pool["rays_o"].shape[0]
        self._perm = np.random.RandomState(self.seed).permutation(n)

    # ------------------------------------------------------------------
    def train_batch(self, step: int, host_id: int = 0, num_hosts: int = 1) -> Dict[str, np.ndarray]:
        """Fixed-shape [N_rand, ...] batch for global ``step``; hosts draw
        disjoint offsets / RNG streams."""
        if self.batching:
            return self._pooled_batch(step, host_id, num_hosts)
        return self._image_batch(step, host_id, num_hosts)

    def _pooled_batch(self, step, host_id, num_hosts):
        pool, perm = self._pool, self._perm
        n = perm.shape[0]
        stride = self.N_rand * num_hosts
        start = (step * stride + host_id * self.N_rand) % max(n - self.N_rand, 1)
        idx = perm[start : start + self.N_rand]
        if idx.shape[0] < self.N_rand:  # wrap
            idx = np.concatenate([idx, perm[: self.N_rand - idx.shape[0]]])
        out = {k: v[idx] for k, v in pool.items()}
        out["near"] = np.full((self.N_rand, 1), self.near, np.float32)
        out["far"] = np.full((self.N_rand, 1), self.far, np.float32)
        return out

    def _image_batch(self, step, host_id, num_hosts):
        rng = np.random.RandomState((self.seed + step) * num_hosts + host_id + 1)
        img_i = self.i_train[rng.randint(len(self.i_train))]
        target = self.imgs[img_i]
        pose = self.poses[img_i]
        rays_o, rays_d = get_rays_np(self.H, self.W, self.K, pose)
        H, W = self.H, self.W
        if step < self.precrop_iters:
            dH = int(H // 2 * self.precrop_frac)
            dW = int(W // 2 * self.precrop_frac)
            ys = np.arange(H // 2 - dH, H // 2 + dH)
            xs = np.arange(W // 2 - dW, W // 2 + dW)
        else:
            ys = np.arange(H)
            xs = np.arange(W)
        coords = np.stack(np.meshgrid(ys, xs, indexing="ij"), -1).reshape(-1, 2)
        sel = coords[rng.choice(coords.shape[0], size=self.N_rand, replace=False)]
        out = {
            "rays_o": rays_o[sel[:, 0], sel[:, 1]],
            "rays_d": rays_d[sel[:, 0], sel[:, 1]],
            "target": target[sel[:, 0], sel[:, 1]],
        }
        if self.with_radii:
            radii = get_ray_radii(rays_d)
            out["radii"] = radii[sel[:, 0], sel[:, 1]]
        if self.use_ndc:
            out["rays_o"], out["rays_d"] = ndc_rays(
                H, W, self.focal, 1.0, out["rays_o"], out["rays_d"]
            )
        out["near"] = np.full((self.N_rand, 1), self.near, np.float32)
        out["far"] = np.full((self.N_rand, 1), self.far, np.float32)
        return out

    # ------------------------------------------------------------------
    def image_rays(
        self, img_i: Optional[int], pose: Optional[np.ndarray] = None
    ) -> Dict[str, np.ndarray]:
        """Full-image rays (flattened [H*W, ...]) + target for eval.

        Pass ``pose`` (and ``img_i=None``) to render a novel view.
        """
        if pose is None:
            pose = self.poses[img_i]
        rays_o, rays_d = get_rays_np(self.H, self.W, self.K, pose)
        out = {
            "rays_o": rays_o.reshape(-1, 3),
            "rays_d": rays_d.reshape(-1, 3),
        }
        if self.with_radii:
            out["radii"] = get_ray_radii(rays_d).reshape(-1, 1)
        if self.use_ndc:
            out["rays_o"], out["rays_d"] = ndc_rays(
                self.H, self.W, self.focal, 1.0, out["rays_o"], out["rays_d"]
            )
        n = out["rays_o"].shape[0]
        out["near"] = np.full((n, 1), self.near, np.float32)
        out["far"] = np.full((n, 1), self.far, np.float32)
        if img_i is not None and img_i < len(self.imgs):
            out["target"] = self.imgs[img_i].reshape(-1, 3)
        return out

    def eval_item(self, img_i: int):
        """(rays dict, gt image [H,W,3]) — the hook-facing eval protocol."""
        return self.image_rays(img_i), self.imgs[img_i]

    def spiral_item(self, pose: np.ndarray):
        """(rays dict, (H, W)) for a novel render pose."""
        return self.image_rays(None, pose=pose), (self.H, self.W)

    @property
    def num_val(self):
        return len(self.i_val)

    @property
    def num_test(self):
        return len(self.i_test)
