"""BungeeNeRF dataset (multi-scale zoom-level scenes, progressive stages) —
a copy of ``xrnerf_tpu/datasets/bungee.py``: per-ray pixel-footprint
``radii`` and a per-image ``scale_code`` (zoom stage), training rays pooled
over all images and drawn through one permutation, and the curriculum
``stage`` (a 0-d array from the global step) with every batch.

Two layouts: blender-style ``transforms_{split}.json`` (scale codes from
``np.digitize`` of the camera-to-centre distance over its quantiles, far
cameras stage 0), and the google-earth captures (``load/google.py``:
``scale_split`` gives each stage's first image).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..registry import DATASETS
from .load.blender import load_blender_data
from .rays import get_ray_radii, get_rays_np, intrinsics_from_hwf
from .scene import apply_white_bkgd


@DATASETS.register
class BungeeDataset:
    def __init__(
        self,
        datadir: str,
        dataset_type: str = "blender",  # or "google" (mutiscale_google)
        n_stages: int = 4,
        iters_per_stage: int = 50000,
        white_bkgd: bool = False,
        N_rand: int = 1024,
        testskip: int = 1,
        near: float = 2.0,
        far: float = 6.0,
        factor: int = 3,
        holdout: int = 16,
        seed: int = 0,
    ):
        self.N_rand = int(N_rand)
        self.n_stages = n_stages
        self.iters_per_stage = int(iters_per_stage)
        self.near, self.far = float(near), float(far)
        self.seed = seed

        scale_split = None
        if dataset_type == "google":
            # the real google-earth layout: scale_split marks where each
            # progressive stage's (farther) cameras begin (load.py:145-173)
            from .load.google import load_google_data

            imgs, gposes, scene_scale, scene_origin, scale_split = load_google_data(datadir, factor=factor)
            imgs = imgs[..., :4]
            hwf = [int(gposes[0, 0, 4]), int(gposes[0, 1, 4]), float(gposes[0, 2, 4])]
            poses4 = np.broadcast_to(
                np.eye(4, dtype=np.float32), (len(gposes), 4, 4)
            ).copy()
            poses4[:, :3, :4] = gposes[:, :3, :4]
            poses = poses4
            i_test = np.arange(len(imgs))[:: max(holdout, 1)]
            i_train = np.asarray([i for i in range(len(imgs)) if i not in set(i_test)])
            i_split = [i_train, i_test, i_test]
            render_poses = poses[i_test]
            self.scene_scale, self.scene_origin = scene_scale, scene_origin
        else:
            imgs, poses, render_poses, hwf, i_split = load_blender_data(
                datadir, half_res=False, testskip=testskip
            )
        self.imgs = (
            apply_white_bkgd(imgs) if white_bkgd else imgs[..., :3]
        ).astype(np.float32)
        self.poses = poses
        self.render_poses = render_poses
        self.H, self.W = int(hwf[0]), int(hwf[1])
        self.focal = float(hwf[2])
        self.K = intrinsics_from_hwf(self.H, self.W, self.focal)
        self.i_train, self.i_val, self.i_test = [np.asarray(s) for s in i_split]

        if scale_split is not None:
            # images are ordered far->near; scale_split[s] is stage s's
            # first index (load_rays_bungee semantics)
            n_stages = max(n_stages, len(scale_split))
            self.n_stages = len(scale_split)
            self.scale_codes = np.zeros(len(self.imgs), np.int32)
            for s, start in enumerate(scale_split):
                self.scale_codes[start:] = s
        else:
            # per-image scale codes from camera distance quantiles (far -> 0)
            center = poses[self.i_train, :3, 3].mean(0)
            dists = np.linalg.norm(poses[:, :3, 3] - center, axis=-1)
            qs = np.quantile(
                dists[self.i_train], np.linspace(1, 0, n_stages + 1)[1:-1]
            )
            self.scale_codes = np.digitize(-dists, np.sort(-qs)).astype(np.int32)

        # pooled train rays with radii + scale codes
        chunks = {k: [] for k in ("rays_o", "rays_d", "target", "radii", "scale_code")}
        for i in self.i_train:
            o, d = get_rays_np(self.H, self.W, self.K, poses[i])
            chunks["rays_o"].append(o.reshape(-1, 3))
            chunks["rays_d"].append(d.reshape(-1, 3))
            chunks["target"].append(self.imgs[i].reshape(-1, 3))
            chunks["radii"].append(get_ray_radii(d).reshape(-1, 1))
            chunks["scale_code"].append(
                np.full((self.H * self.W, 1), self.scale_codes[i], np.float32)
            )
        self._pool = {k: np.concatenate(v) for k, v in chunks.items()}
        self._perm = np.random.RandomState(seed).permutation(
            self._pool["rays_o"].shape[0]
        )

    def stage_of(self, step: int) -> int:
        return min(step // self.iters_per_stage, self.n_stages - 1)

    def train_batch(self, step: int, host_id: int = 0, num_hosts: int = 1) -> Dict[str, np.ndarray]:
        n = self._perm.shape[0]
        stride = self.N_rand * num_hosts
        start = (step * stride + host_id * self.N_rand) % max(n - self.N_rand, 1)
        idx = self._perm[start : start + self.N_rand]
        if idx.shape[0] < self.N_rand:
            idx = np.concatenate([idx, self._perm[: self.N_rand - idx.shape[0]]])
        out = {k: v[idx] for k, v in self._pool.items()}
        out["near"] = np.full((self.N_rand, 1), self.near, np.float32)
        out["far"] = np.full((self.N_rand, 1), self.far, np.float32)
        out["stage"] = np.asarray(self.stage_of(step), np.int32)
        return out

    def _image_rays(self, pose: np.ndarray) -> Dict[str, np.ndarray]:
        o, d = get_rays_np(self.H, self.W, self.K, pose)
        n = self.H * self.W
        return {
            "rays_o": o.reshape(-1, 3),
            "rays_d": d.reshape(-1, 3),
            "radii": get_ray_radii(d).reshape(-1, 1),
            "near": np.full((n, 1), self.near, np.float32),
            "far": np.full((n, 1), self.far, np.float32),
        }

    def eval_item(self, img_i: int):
        return self._image_rays(self.poses[img_i]), self.imgs[img_i]

    def spiral_item(self, pose: np.ndarray):
        return self._image_rays(pose), (self.H, self.W)
