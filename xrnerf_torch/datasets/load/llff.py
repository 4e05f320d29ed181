"""LLFF (forward-facing real scenes) loader — a copy of
``xrnerf_tpu/datasets/load/llff.py``: ``poses_bounds.npy`` parsing, the
axis convention fix, ``bd_factor`` rescale, recentering, optional
spherification, the spiral render path and the ``llffhold`` test split.
Images are read from an ``images_<factor>`` directory when there is one,
else from ``images/`` and area-downscaled in memory
(``load/resize.py:area_resize``, OpenCV's ``INTER_AREA`` rounding for
``uint8``). Images are read by ``utils/png.py:imread``: PNGs and JPEGs
without ``imageio`` (other formats through it).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from ...utils.png import imread
from .resize import area_resize


def _load_images(basedir: str, factor: int) -> np.ndarray:
    suffix = f"_{factor}" if factor > 1 else ""
    imgdir = os.path.join(basedir, "images" + suffix)
    resize = False
    if not os.path.isdir(imgdir):
        imgdir = os.path.join(basedir, "images")
        resize = factor > 1
    files = sorted(
        os.path.join(imgdir, f)
        for f in os.listdir(imgdir)
        if f.lower().endswith(("jpg", "jpeg", "png"))
    )
    imgs = []
    for f in files:
        im = imread(f)[..., :3]
        if resize:
            im = area_resize(im, im.shape[0] // factor, im.shape[1] // factor)
        imgs.append(im / 255.0)
    return np.stack(imgs).astype(np.float32)


def _viewmatrix(z, up, pos):
    vec2 = z / np.linalg.norm(z)
    vec1_avg = up
    vec0 = np.cross(vec1_avg, vec2)
    vec0 = vec0 / np.linalg.norm(vec0)
    vec1 = np.cross(vec2, vec0)
    return np.stack([vec0, vec1, vec2, pos], 1)


def _poses_avg(poses):
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = poses[:, :3, 2].sum(0)
    up = poses[:, :3, 1].sum(0)
    c2w = np.concatenate([_viewmatrix(vec2, up, center), hwf], 1)
    return c2w


def _recenter_poses(poses):
    poses_ = poses.copy()
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = _poses_avg(poses)
    c2w = np.concatenate([c2w[:3, :4], bottom], -2)
    bottom = np.tile(np.reshape(bottom, [1, 1, 4]), [poses.shape[0], 1, 1])
    p34 = np.concatenate([poses[:, :3, :4], bottom], -2)
    p34 = np.linalg.inv(c2w) @ p34
    poses_[:, :3, :4] = p34[:, :3, :4]
    return poses_


def _render_path_spiral(c2w, up, rads, focal, zrate, rots, N):
    render_poses = []
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]:
        c = np.dot(
            c2w[:3, :4],
            np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]) * rads,
        )
        z = c - np.dot(c2w[:3, :4], np.array([0, 0, -focal, 1.0]))
        render_poses.append(np.concatenate([_viewmatrix(z, up, c), hwf], 1))
    return np.stack(render_poses)


def _spherify_poses(poses, bds):
    p34_to_44 = lambda p: np.concatenate(
        [p, np.tile(np.reshape(np.eye(4)[-1, :], [1, 1, 4]), [p.shape[0], 1, 1])], 1
    )
    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    def min_line_dist(rays_o, rays_d):
        A_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
        b_i = -A_i @ rays_o
        pt_mindist = np.squeeze(
            -np.linalg.inv((np.transpose(A_i, [0, 2, 1]) @ A_i).mean(0)) @ (b_i).mean(0)
        )
        return pt_mindist

    pt_mindist = min_line_dist(rays_o, rays_d)
    center = pt_mindist
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = up / np.linalg.norm(up)
    vec1 = np.cross([0.1, 0.2, 0.3], vec0)
    vec1 /= np.linalg.norm(vec1)
    vec2 = np.cross(vec0, vec1)
    pos = center
    c2w = np.stack([vec1, vec2, vec0, pos], 1)

    poses_reset = np.linalg.inv(p34_to_44(c2w[None])) @ p34_to_44(poses[:, :3, :4])
    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(rad**2 - zh**2)
    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.array([radcircle * np.cos(th), radcircle * np.sin(th), zh])
        up = np.array([0, 0, -1.0])
        vec2 = camorigin / np.linalg.norm(camorigin)
        vec0 = np.cross(vec2, up)
        vec0 /= np.linalg.norm(vec0)
        vec1 = np.cross(vec2, vec0)
        p = np.stack([vec0, vec1, vec2, camorigin], 1)
        new_poses.append(p)
    new_poses = np.stack(new_poses, 0)
    new_poses = np.concatenate(
        [new_poses, np.broadcast_to(poses[0, :3, -1:], new_poses[:, :3, -1:].shape)], -1
    )
    poses_reset = np.concatenate(
        [poses_reset[:, :3, :4], np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape)],
        -1,
    )
    return poses_reset, new_poses, bds


def load_llff_data(
    basedir: str,
    factor: int = 8,
    recenter: bool = True,
    bd_factor: float = 0.75,
    spherify: bool = False,
    llffhold: int = 8,
    path_zflat: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, list]:
    """Returns (imgs [N,H,W,3], poses [N,3,5], bds [N,2], render_poses,
    i_split [train, val, test])."""
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])

    imgs = _load_images(basedir, factor)
    # adjust hwf for the actual loaded resolution
    poses[:2, 4, :] = np.array(imgs.shape[1:3]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] * 1.0 / factor

    # LLFF [down right back] -> NeRF [right up back]
    poses = np.concatenate([poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)  # [N, 3, 5]
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)  # [N, 2]

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds *= sc

    if recenter:
        poses = _recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = _spherify_poses(poses, bds)
    else:
        c2w = _poses_avg(poses)
        up = poses[:, :3, 1].sum(0)
        up = up / np.linalg.norm(up)
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        mean_dz = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
        focal = mean_dz
        tt = poses[:, :3, 3]
        rads = np.percentile(np.abs(tt), 90, 0)
        c2w_path = c2w
        N_views, N_rots = 120, 2
        if path_zflat:
            zloc = -close_depth * 0.1
            c2w_path[:3, 3] = c2w_path[:3, 3] + zloc * c2w_path[:3, 2]
            rads[2] = 0.0
            N_rots, N_views = 1, N_views // 2
        render_poses = _render_path_spiral(
            c2w_path, up, rads, focal, zrate=0.5, rots=N_rots, N=N_views
        )
    render_poses = np.asarray(render_poses, dtype=np.float32)

    n = imgs.shape[0]
    dists = np.sum(np.square(_poses_avg(poses)[:3, 3] - poses[:, :3, 3]), -1)
    i_holdout = int(np.argmin(dists))
    if llffhold > 0:
        i_test = np.arange(n)[::llffhold]
    else:
        i_test = np.asarray([i_holdout])
    i_val = i_test
    i_train = np.asarray([i for i in np.arange(n) if i not in i_test])
    return imgs, poses, bds, render_poses, [i_train, i_val, i_test]
