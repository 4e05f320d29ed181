"""LINEMOD dataset loader (6-DoF object pose captures, blender-json style)
— a copy of ``xrnerf_tpu/datasets/load/linemod.py``:
``transforms_{train,val,test}.json`` whose frames carry file paths and an
``intrinsic_matrix``, meta-level near/far (floored / ceiled), the spherical
render path and an optional 2x area half-res. Images are read by
``utils/png.py:imread``: PNGs and JPEGs without ``imageio`` (other formats
through it).
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from ...utils.png import imread
from ..rays import spherical_render_poses


def _area_downscale2(imgs: np.ndarray) -> np.ndarray:
    """2x box-average downscale (cv2 INTER_AREA at integer factor)."""
    n, h, w = imgs.shape[:3]
    return imgs[:, : h - h % 2, : w - w % 2].reshape(
        n, h // 2, 2, w // 2, 2, -1
    ).mean((2, 4))


def load_linemod_data(
    datadir: str, half_res: bool = False, testskip: int = 1
) -> Tuple:
    """-> (imgs [N,H,W,C], poses [N,4,4], render_poses, [H,W,focal], K,
    i_split, near, far)."""
    splits = ["train", "val", "test"]
    metas = {
        s: json.load(open(os.path.join(datadir, f"transforms_{s}.json")))
        for s in splits
    }

    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        meta = metas[s]
        skip = 1 if s == "train" or testskip == 0 else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            fname = frame["file_path"]
            if not os.path.isabs(fname) and not os.path.exists(fname):
                fname = os.path.join(datadir, fname)
            imgs.append(imread(fname))
            poses.append(np.asarray(frame["transform_matrix"], np.float32))
        all_imgs.append((np.asarray(imgs) / 255.0).astype(np.float32))
        all_poses.append(np.stack(poses))
        counts.append(counts[-1] + len(imgs))

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    H, W = imgs.shape[1:3]
    K = np.asarray(metas["test"]["frames"][0]["intrinsic_matrix"], np.float32)
    focal = float(K[0][0])

    render_poses = spherical_render_poses(n=40, phi=-30.0, radius=4.0)

    if half_res:
        H, W = H // 2, W // 2
        focal = focal / 2.0
        K = K / 2.0
        K[2, 2] = 1.0
        imgs = _area_downscale2(imgs)[..., :3].astype(np.float32)

    near = float(np.floor(min(metas["train"]["near"], metas["test"]["near"])))
    far = float(np.ceil(max(metas["train"]["far"], metas["test"]["far"])))
    return imgs, poses, render_poses, [int(H), int(W), focal], K, i_split, near, far
