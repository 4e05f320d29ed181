"""Mip-NeRF multiscale blender dataset (numpy) — port of
``xrnerf_tpu/datasets/multiscale.py``: each blender image is area-downscaled
by 2, 4 and 8 (``load/resize.py:area_resize``, OpenCV's ``INTER_AREA`` in
numpy); every ray carries its pixel footprint ``radii`` and a ``lossmult =
4^scale`` weight so all scales count alike.

Training draws from one pool of every train image's rays at every scale,
shuffled once; eval items are ``(image, scale)`` pairs, val items first,
then test items, interleaved so that an item's index modulo ``n_scales`` is
its scale (what ``TestHook(ndown=...)`` reads).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..registry import DATASETS
from .load.blender import load_blender_data
from .load.resize import area_resize
from .rays import get_ray_radii, get_rays_np, intrinsics_from_hwf
from .scene import apply_white_bkgd


@DATASETS.register
class MipMultiScaleDataset:
    def __init__(
        self,
        datadir: str,
        n_scales: int = 4,
        white_bkgd: bool = True,
        N_rand: int = 1024,
        testskip: int = 8,
        near: float = 2.0,
        far: float = 6.0,
        seed: int = 0,
    ):
        self.N_rand = int(N_rand)
        self.n_scales = n_scales
        self.near, self.far = float(near), float(far)
        self.seed = seed

        imgs, poses, render_poses, hwf, i_split = load_blender_data(datadir, half_res=False, testskip=testskip)
        imgs3 = apply_white_bkgd(imgs) if white_bkgd else imgs[..., :3]
        H0, W0, f0 = int(hwf[0]), int(hwf[1]), float(hwf[2])
        self.render_poses = render_poses
        self.poses = poses

        self.scales: List[Dict] = [
            {"H": H0 // 2**s, "W": W0 // 2**s, "focal": f0 / 2**s, "lossmult": float(4**s)}
            for s in range(n_scales)
        ]
        self._imgs_by_scale = [imgs3] + [
            np.stack([area_resize(im, sc["H"], sc["W"]) for im in imgs3]) for sc in self.scales[1:]
        ]

        tr, va, te = i_split
        self.i_train_imgs = np.asarray(tr)
        val_items = [(int(i), s) for i in va for s in range(n_scales)]
        test_items = [(int(i), s) for i in te for s in range(n_scales)]
        self._eval_items = val_items + test_items
        self.i_val = np.arange(len(val_items))
        self.i_test = np.arange(len(val_items), len(val_items) + len(test_items))
        self.H, self.W, self.focal = H0, W0, f0

        self._build_pool()

    # ------------------------------------------------------------------
    def _build_pool(self):
        chunks: Dict[str, list] = {"rays_o": [], "rays_d": [], "target": [], "radii": [], "lossmult": []}
        for s, sc in enumerate(self.scales):
            K = intrinsics_from_hwf(sc["H"], sc["W"], sc["focal"])
            for i in self.i_train_imgs:
                o, d = get_rays_np(sc["H"], sc["W"], K, self.poses[i])
                chunks["rays_o"].append(o.reshape(-1, 3))
                chunks["rays_d"].append(d.reshape(-1, 3))
                chunks["target"].append(self._imgs_by_scale[s][i].reshape(-1, 3).astype(np.float32))
                chunks["radii"].append(get_ray_radii(d).reshape(-1, 1))
                chunks["lossmult"].append(np.full((sc["H"] * sc["W"], 1), sc["lossmult"], np.float32))
        self._pool = {k: np.concatenate(v, 0) for k, v in chunks.items()}
        n = self._pool["rays_o"].shape[0]
        self._perm = np.random.RandomState(self.seed).permutation(n)

    def train_batch(self, step: int, host_id: int = 0, num_hosts: int = 1):
        """Fixed-shape [N_rand, ...] batch for global ``step``; hosts draw
        disjoint offsets of the shuffled pool."""
        n = self._perm.shape[0]
        stride = self.N_rand * num_hosts
        start = (step * stride + host_id * self.N_rand) % max(n - self.N_rand, 1)
        idx = self._perm[start : start + self.N_rand]
        if idx.shape[0] < self.N_rand:
            idx = np.concatenate([idx, self._perm[: self.N_rand - idx.shape[0]]])
        out = {k: v[idx] for k, v in self._pool.items()}
        out["near"] = np.full((self.N_rand, 1), self.near, np.float32)
        out["far"] = np.full((self.N_rand, 1), self.far, np.float32)
        return out

    # ------------------------------------------------------------------
    def _rays_for(self, pose: np.ndarray, scale: int):
        sc = self.scales[scale]
        K = intrinsics_from_hwf(sc["H"], sc["W"], sc["focal"])
        o, d = get_rays_np(sc["H"], sc["W"], K, pose)
        n = sc["H"] * sc["W"]
        return {
            "rays_o": o.reshape(-1, 3),
            "rays_d": d.reshape(-1, 3),
            "radii": get_ray_radii(d).reshape(-1, 1),
            "near": np.full((n, 1), self.near, np.float32),
            "far": np.full((n, 1), self.far, np.float32),
        }

    def eval_item(self, item_i: int):
        """(rays dict, gt image [H, W, 3]) of eval item ``item_i``."""
        img_i, s = self._eval_items[item_i]
        return self._rays_for(self.poses[img_i], s), self._imgs_by_scale[s][img_i]

    def spiral_item(self, pose: np.ndarray):
        """(rays dict, (H, W)) for a novel render pose at full resolution."""
        sc = self.scales[0]
        return self._rays_for(pose, 0), (sc["H"], sc["W"])
