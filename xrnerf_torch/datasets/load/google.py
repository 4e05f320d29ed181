"""Multiscale Google-Earth loader (BungeeNeRF city scenes) — a copy of
``xrnerf_tpu/datasets/load/google.py``: an ``images/`` directory and
``poses_enu.json`` with llff-style [3, 5] pose rows (last column
[H, W, focal]), ``scene_scale`` / ``scene_origin``, and ``scale_split``,
the index where each progressive stage's cameras begin (stage 0 the
farthest). Images are read by ``utils/png.py:imread``: PNGs and JPEGs
without ``imageio`` (other formats through it).
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from ...utils.png import imread

def _area_downscale(img: np.ndarray, factor: int) -> np.ndarray:
    h, w = img.shape[:2]
    h2, w2 = h // factor, w // factor
    return img[: h2 * factor, : w2 * factor].reshape(h2, factor, w2, factor, -1).mean((1, 3))


def load_google_data(datadir: str, factor: int = 3) -> Tuple:
    """-> (imgs [N,H,W,C], poses [N,3,5], scene_scale, scene_origin [3],
    scale_split list)."""
    imgdir = os.path.join(datadir, "images")
    files = [
        os.path.join(imgdir, f)
        for f in sorted(os.listdir(imgdir))
        if f.lower().endswith((".jpg", ".jpeg", ".png"))
    ]
    imgs = []
    for f in files:
        im = imread(f).astype(np.float32) / 255.0
        if factor and factor > 1:
            im = _area_downscale(im, int(factor))
        imgs.append(im.astype(np.float32))
    imgs = np.stack(imgs)

    with open(os.path.join(datadir, "poses_enu.json")) as fh:
        data = json.load(fh)
    poses = np.asarray(data["poses"], np.float32)[:, :-2].reshape(-1, 3, 5)
    h, w = imgs.shape[1:3]
    poses[:, 0, 4] = h
    poses[:, 1, 4] = w
    poses[:, 2, 4] = poses[:, 2, 4] / float(factor or 1)

    scene_scale = data["scene_scale"]
    scene_origin = np.asarray(data["scene_origin"], np.float32)
    scale_split = data["scale_split"]
    return imgs, poses, scene_scale, scene_origin, scale_split
