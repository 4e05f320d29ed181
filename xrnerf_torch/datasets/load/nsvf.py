"""NSVF-style dataset loader (Synthetic_NeRF / Synthetic_NSVF / BlendedMVS
/ TanksAndTemple layouts) — a copy of ``xrnerf_tpu/datasets/load/nsvf.py``:
``rgb/`` images named ``<split>_*`` (0 train, 1 val, 2 test), per-image
``pose/<name>.txt`` camera-to-world matrices with the NSVF y/z flip,
``intrinsics.txt`` (a full matrix or an "f cx cy 0" line), the ``bbox.txt``
global domain, near/far from ``near_and_far.txt`` or from the cameras'
distances to the box. Images are read by ``utils/png.py:imread``: PNGs
and JPEGs without ``imageio`` (other formats through it).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ...utils.png import imread

def load_matrix(path: str) -> np.ndarray:
    return np.array(
        [[float(w) for w in line.strip().split()] for line in open(path)],
        dtype=np.float32,
    )


def load_nsvf_intrinsics(path: str) -> np.ndarray:
    """-> [3,3] K. Accepts a 3x3/4x4 matrix file or the 'f cx cy 0' form."""
    try:
        m = load_matrix(path)
        if m.shape == (3, 3):
            return m
        if m.shape == (4, 4):
            return m[:3, :3]
    except ValueError:
        pass
    with open(path) as fh:
        f, cx, cy, _ = map(float, fh.readline().split())
    return np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float32)


def _nsvf_pose(path: str) -> np.ndarray:
    """Pose txt -> [4,4] c2w in NeRF (OpenGL) convention: NSVF stores
    camera-to-world with +y down / +z forward, so columns 1:3 negate."""
    m = load_matrix(path)
    if m.shape == (3, 4):
        m = np.vstack([m, np.array([[0, 0, 0, 1.0]], np.float32)])
    m = m.reshape(4, 4).astype(np.float32)
    m[:3, 1:3] = -m[:3, 1:3]
    return m


def _aabb_near_far(cam_pos: np.ndarray, bmin: np.ndarray, bmax: np.ndarray):
    """Min distance to the box / max distance to the far corner, over all
    camera positions (the reference's closest/furthest point-in-box)."""
    lo = np.maximum(bmin - cam_pos, 0.0)
    hi = np.maximum(cam_pos - bmax, 0.0)
    near = np.min(np.linalg.norm(lo + hi, axis=-1))
    mid = 0.5 * (bmin + bmax)
    far_corner = np.where(cam_pos > mid, bmin, bmax)
    far = np.max(np.linalg.norm(cam_pos - far_corner, axis=-1))
    return float(near), float(far)


def load_nsvf_data(
    datadir: str,
    testskip: int = 1,
    test_traj_path: Optional[str] = None,
) -> Tuple:
    """-> (imgs [N,H,W,C] float, poses [N,4,4] c2w, K [3,3], near, far,
    bbox (bmin, bmax), bg_color or None, render_poses [M,4,4], i_split)."""
    rgb_dir = os.path.join(datadir, "rgb")
    pose_dir = os.path.join(datadir, "pose")

    imgs, poses, all_cam_pos = [], [], []
    i_split = [[], [], []]
    counters = [0, 0, 0]
    index = 0
    for fname in sorted(os.listdir(rgb_dir)):
        stem, ext = os.path.splitext(fname)
        if ext.lower() not in (".png", ".jpg", ".jpeg"):
            continue
        split = int(fname.split("_")[0])  # 0 train / 1 val / 2 test
        pose = _nsvf_pose(os.path.join(pose_dir, stem + ".txt"))
        all_cam_pos.append(pose[:3, 3])
        keep = split == 0 or counters[split] % max(testskip, 1) == 0
        if split > 0:
            counters[split] += 1
        if not keep:
            continue
        i_split[split].append(index)
        index += 1
        imgs.append(
            (imread(os.path.join(rgb_dir, fname)) / 255.0).astype(
                np.float32
            )
        )
        poses.append(pose)

    imgs = np.stack(imgs)
    poses = np.stack(poses)
    i_split = [np.asarray(s, np.int64) for s in i_split]
    if i_split[2].size == 0:
        i_split[2] = i_split[1]

    K = load_nsvf_intrinsics(os.path.join(datadir, "intrinsics.txt"))

    bbox = load_matrix(os.path.join(datadir, "bbox.txt"))[0, :6]
    bmin, bmax = bbox[:3], bbox[3:6]

    nf_path = os.path.join(datadir, "near_and_far.txt")
    if os.path.isfile(nf_path):
        near, far = (float(v) for v in load_matrix(nf_path)[0][:2])
    else:
        near, far = _aabb_near_far(np.stack(all_cam_pos), bmin, bmax)

    bg = None
    bg_path = os.path.join(datadir, "background_color.txt")
    if os.path.isfile(bg_path):
        bg = load_matrix(bg_path)[0]

    if test_traj_path is None:
        test_traj_path = os.path.join(datadir, "test_traj.txt")
    if os.path.isfile(test_traj_path):
        traj = load_matrix(test_traj_path).reshape(-1, 4, 4)
        render_poses = np.stack(
            [
                np.concatenate(
                    [np.concatenate([p[:3, :1], -p[:3, 1:3], p[:3, 3:]], 1), p[3:]], 0
                )
                for p in traj
            ]
        ).astype(np.float32)
    else:
        render_poses = poses[i_split[2]]

    return imgs, poses, K, near, far, (bmin, bmax), bg, render_poses, i_split
