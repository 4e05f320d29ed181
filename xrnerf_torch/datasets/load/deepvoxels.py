"""DeepVoxels dataset loader — a copy of
``xrnerf_tpu/datasets/load/deepvoxels.py``: train/validation/test
directories, each with ``rgb/`` pngs and ``pose/`` txt 4x4 matrices
(camera-to-world needing a y/z flip), one ``intrinsics.txt`` whose f/cx/cy
are rescaled to the rendered side; the caller derives near/far from the
mean camera radius (hemi_R +- 1). The pngs are read by
``utils/png.py:imread_png`` (no ``imageio``).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from ...utils.png import imread_png
_FLIP_YZ = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


def _parse_dv_intrinsics(path: str, side: int):
    with open(path) as fh:
        f, cx, cy = list(map(float, fh.readline().split()))[:3]
        fh.readline()  # grid barycenter
        fh.readline()  # near plane
        fh.readline()  # scale
        height, width = map(float, fh.readline().split())
    cx = cx / width * side
    cy = cy / height * side
    f = side / height * f
    return f, cx, cy


def _load_dv_poses(posedir: str) -> np.ndarray:
    poses = []
    for f in sorted(os.listdir(posedir)):
        if not f.endswith("txt"):
            continue
        vals = np.array(
            [float(x) for x in open(os.path.join(posedir, f)).read().split()],
            np.float32,
        ).reshape(4, 4)
        poses.append((vals @ _FLIP_YZ)[:3, :4])
    return np.stack(poses)


def _load_dv_imgs(rgbdir: str, skip: int = 1) -> np.ndarray:
    files = [f for f in sorted(os.listdir(rgbdir)) if f.endswith("png")]
    return np.stack(
        [
            imread_png(os.path.join(rgbdir, f)) / 255.0
            for f in files[::skip]
        ]
    ).astype(np.float32)


def load_deepvoxels_data(
    datadir: str, scene: str = "cube", testskip: int = 8, side: int = 0
) -> Tuple:
    """-> (imgs [N,H,W,3], poses [N,3,4], render_poses, [H, W, focal],
    (cx, cy), i_split). near/far = hemi_R -+ 1 where hemi_R is the mean
    camera distance (computed by the caller from poses). ``side=0`` infers
    the render side from the images (the reference hardcodes 512)."""
    base = os.path.join(datadir, "train", scene)
    if not side:
        rgbdir = os.path.join(base, "rgb")
        first = sorted(f for f in os.listdir(rgbdir) if f.endswith("png"))[0]
        side = int(imread_png(os.path.join(rgbdir, first)).shape[0])
    focal, cx, cy = _parse_dv_intrinsics(
        os.path.join(base, "intrinsics.txt"), side
    )

    poses = _load_dv_poses(os.path.join(base, "pose"))
    val_poses = _load_dv_poses(os.path.join(datadir, "validation", scene, "pose"))[
        ::testskip
    ]
    test_poses = _load_dv_poses(os.path.join(datadir, "test", scene, "pose"))[
        ::testskip
    ]

    imgs = _load_dv_imgs(os.path.join(base, "rgb"))
    val_imgs = _load_dv_imgs(os.path.join(datadir, "validation", scene, "rgb"), testskip)
    test_imgs = _load_dv_imgs(os.path.join(datadir, "test", scene, "rgb"), testskip)

    all_imgs = [imgs, val_imgs, test_imgs]
    counts = np.cumsum([0] + [x.shape[0] for x in all_imgs])
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]

    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate([poses, val_poses, test_poses], 0)
    return imgs, poses, test_poses, [side, side, focal], (cx, cy), i_split
