"""Blender (nerf_synthetic) scene loader — a copy of
``xrnerf_tpu/datasets/load/blender.py``: ``transforms_{train,val,test}.json``
+ RGBA pngs, optional ``half_res`` and ``testskip``, and a 40-pose spherical
render path. ``imageio`` and ``cv2`` are imported only when used.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from ..rays import spherical_render_poses


def _imread(path: str) -> np.ndarray:
    import imageio.v2 as imageio

    return np.asarray(imageio.imread(path))


def _half_res(imgs: np.ndarray) -> np.ndarray:
    import cv2

    N, H, W, C = imgs.shape
    out = np.zeros((N, H // 2, W // 2, C), dtype=imgs.dtype)
    for i, im in enumerate(imgs):
        out[i] = cv2.resize(im, (W // 2, H // 2), interpolation=cv2.INTER_AREA)
    return out


def load_blender_data(
    basedir: str, half_res: bool = False, testskip: int = 1
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, list, list]:
    """Returns (imgs [N,H,W,4] float32 in [0,1], poses [N,4,4], render_poses
    [40,4,4], hwf [H,W,focal], i_split [train_idx, val_idx, test_idx])."""
    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as f:
            metas[s] = json.load(f)

    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        meta = metas[s]
        skip = 1 if s == "train" or testskip == 0 else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            fname = os.path.join(basedir, frame["file_path"] + ".png")
            imgs.append(_imread(fname))
            poses.append(np.array(frame["transform_matrix"], dtype=np.float32))
        imgs = (np.stack(imgs) / 255.0).astype(np.float32)
        poses = np.stack(poses)
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(poses)

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    H, W = imgs.shape[1:3]
    camera_angle_x = float(metas["train"]["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

    if half_res:
        imgs = _half_res(imgs)
        H, W = H // 2, W // 2
        focal = focal / 2.0

    render_poses = spherical_render_poses(40, phi=-30.0, radius=4.0)
    return imgs, poses, render_poses, [H, W, focal], i_split
