"""Instant-NGP dataset: blender scenes mapped into NGP grid coordinates —
port of ``xrnerf_tpu/datasets/hashnerf.py`` (numpy): ``pose_nerf2ngp`` (axis
cycle + scale 0.33 + offset 0.5), a shuffled global ray pool over all train
pixels, RGBA targets for alpha-masked metrics.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..registry import DATASETS
from .load.blender import load_blender_data
from .rays import get_rays_np, intrinsics_from_hwf


def pose_nerf2ngp(pose: np.ndarray, scale: float = 0.33, offset: float = 0.5) -> np.ndarray:
    """NeRF c2w -> NGP c2w: cycle axes (x,y,z)->(y,z,x), scale+offset
    translation so the scene sits in the unit cube."""
    p = pose[:3].copy()
    p = p[[1, 2, 0], :]
    p[:, 3] = p[:, 3] * scale + offset
    out = np.eye(4, dtype=np.float32)
    out[:3] = p
    return out


@DATASETS.register
class HashNerfDataset:
    def __init__(
        self,
        datadir: str,
        half_res: bool = False,
        testskip: int = 8,
        white_bkgd: bool = True,
        N_rand: int = 4096,
        scale: float = 0.33,
        offset: float = 0.5,
        seed: int = 0,
    ):
        self.N_rand = int(N_rand)
        self.seed = seed

        imgs, poses, render_poses, hwf, i_split = load_blender_data(
            datadir, half_res=half_res, testskip=testskip
        )
        self.H, self.W = int(hwf[0]), int(hwf[1])
        self.focal = float(hwf[2])
        self.K = intrinsics_from_hwf(self.H, self.W, self.focal)

        self.alphas = imgs[..., 3:4].astype(np.float32)
        if white_bkgd:
            self.imgs = (imgs[..., :3] * imgs[..., 3:4] + (1.0 - imgs[..., 3:4])).astype(np.float32)
        else:
            self.imgs = imgs[..., :3].astype(np.float32)

        self.poses_ngp = np.stack([pose_nerf2ngp(p, scale, offset) for p in poses])
        self.render_poses = np.stack([pose_nerf2ngp(p, scale, offset) for p in render_poses])
        self.i_train, self.i_val, self.i_test = [np.asarray(s) for s in i_split]

        # global shuffled ray pool over train pixels
        tr = self.i_train
        all_o, all_d = [], []
        for p in self.poses_ngp[tr]:
            o, d = get_rays_np(self.H, self.W, self.K, p)
            all_o.append(o)
            all_d.append(d)
        self._pool = {
            "rays_o": np.stack(all_o).reshape(-1, 3),
            "rays_d": np.stack(all_d).reshape(-1, 3),
            "target": self.imgs[tr].reshape(-1, 3),
            "alpha": self.alphas[tr].reshape(-1, 1),
        }
        self._perm = np.random.RandomState(seed).permutation(self._pool["rays_o"].shape[0])

    def train_batch(self, step: int, host_id: int = 0, num_hosts: int = 1) -> Dict[str, np.ndarray]:
        n = self._perm.shape[0]
        stride = self.N_rand * num_hosts
        start = (step * stride + host_id * self.N_rand) % max(n - self.N_rand, 1)
        idx = self._perm[start : start + self.N_rand]
        if idx.shape[0] < self.N_rand:
            idx = np.concatenate([idx, self._perm[: self.N_rand - idx.shape[0]]])
        return {k: v[idx] for k, v in self._pool.items()}

    def image_rays(self, img_i, pose: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        if pose is None:
            pose = self.poses_ngp[img_i]
        o, d = get_rays_np(self.H, self.W, self.K, pose)
        return {"rays_o": o.reshape(-1, 3), "rays_d": d.reshape(-1, 3)}

    def eval_item(self, img_i: int):
        return self.image_rays(img_i), self.imgs[img_i]

    def spiral_item(self, pose: np.ndarray):
        return self.image_rays(None, pose=pose), (self.H, self.W)
