"""Procedural scenes for tests and card runs — a numpy copy of
``xrnerf_tpu/datasets/load/synthetic.py:_trace_sphere``,
``make_synthetic_blender``, ``make_synthetic_zju``, ``make_icosphere`` and
``make_synthetic_genebody``: an analytically ray-traced sphere coloured by
its normal, written as a nerf_synthetic layout (``transforms_{split}.json``
+ RGBA pngs); an in-memory ZJU-MoCap-like capture (a sphere "person" point
cloud seen by a ring of ``x_cam = R x + T`` cameras); and an in-memory
GeneBody-like capture (an icosphere "person" seen by a ring of OpenCV
cameras, with masks and SMPL depth). The same seed gives the same arrays
and files as the JAX package. The pngs are written by
``utils/png.py:imwrite_png`` (no ``imageio``).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ...utils.png import imwrite_png
from ..rays import get_rays_np, intrinsics_from_hwf, pose_spherical


def _trace_sphere(H, W, focal, c2w, radius=1.0):
    """Ray-trace a normal-colored sphere at the origin. Returns [H,W,4] u8."""
    K = intrinsics_from_hwf(H, W, focal)
    rays_o, rays_d = get_rays_np(H, W, K, c2w)
    d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    o = rays_o
    b = np.sum(o * d, axis=-1)
    c = np.sum(o * o, axis=-1) - radius**2
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    hit &= t > 0
    p = o + t[..., None] * d
    n = p / radius
    rgb = np.clip(0.5 * (n + 1.0), 0.0, 1.0)
    img = np.zeros((H, W, 4), dtype=np.float32)
    img[..., :3] = np.where(hit[..., None], rgb, 0.0)
    img[..., 3] = hit.astype(np.float32)
    return (img * 255).astype(np.uint8)


def make_synthetic_zju(
    n_frames: int = 2,
    n_cams: int = 4,
    H: int = 32,
    W: int = 32,
    n_verts: int = 500,
    radius: float = 0.3,
    cam_dist: float = 2.0,
    seed: int = 0,
):
    """In-memory ZJU-MoCap-like arrays: a sphere 'person' point cloud seen
    by a ring of x_cam = R x + T pinhole cameras. Returns the ``arrays``
    dict accepted by NeuralBodyDataset/AniNeRFDataset."""
    from ..neuralbody import rays_from_KRT

    rng = np.random.RandomState(seed)
    # sphere point cloud ("SMPL vertices"), drifting slightly per frame
    v = rng.randn(n_verts, 3)
    v = radius * v / np.linalg.norm(v, axis=-1, keepdims=True)
    verts = np.stack(
        [v + 0.03 * f * np.array([1.0, 0, 0]) for f in range(n_frames)]
    ).astype(np.float32)

    focal = 0.9 * W
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    Ks, Rs, Ts = [], [], []
    for c in range(n_cams):
        th = 2 * np.pi * c / n_cams
        pos = cam_dist * np.array([np.cos(th), np.sin(th), 0.15])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0, 0, 1.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd]).astype(np.float32)
        Ks.append(K)
        Rs.append(R)
        Ts.append((-R @ pos).astype(np.float32))

    imgs = np.zeros((n_frames, n_cams, H, W, 3), np.float32)
    masks = np.zeros((n_frames, n_cams, H, W), np.float32)
    for f in range(n_frames):
        center = verts[f].mean(0)
        for c in range(n_cams):
            o, d = rays_from_KRT(H, W, Ks[c], Rs[c], Ts[c])
            dn = d / np.linalg.norm(d, axis=-1, keepdims=True)
            oc = o - center
            b = np.sum(oc * dn, -1)
            disc = b * b - (np.sum(oc * oc, -1) - radius**2)
            hit = disc > 0
            t = -b - np.sqrt(np.maximum(disc, 0))
            hit &= t > 0
            p = oc + t[..., None] * dn
            rgb = np.clip(0.5 * (p / radius + 1.0), 0, 1)
            imgs[f, c] = np.where(hit[..., None], rgb, 0.0).reshape(H, W, 3)
            masks[f, c] = hit.astype(np.float32).reshape(H, W)

    return {
        "imgs": imgs,
        "masks": masks,
        "K": np.stack(Ks),
        "R": np.stack(Rs),
        "T": np.stack(Ts),
        "verts": verts,
    }


def make_synthetic_blender(
    out_dir: str,
    n_train: int = 4,
    n_val: int = 2,
    n_test: int = 2,
    H: int = 32,
    W: int = 32,
    camera_angle_x: float = 0.6911112070083618,
    radius: float = 4.0,
    seed: int = 0,
) -> str:
    """Write a tiny nerf_synthetic-layout scene; returns ``out_dir``."""
    rng = np.random.RandomState(seed)
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    counts = {"train": n_train, "val": n_val, "test": n_test}
    for split, n in counts.items():
        os.makedirs(os.path.join(out_dir, split), exist_ok=True)
        frames = []
        for i in range(n):
            theta = float(rng.uniform(-180, 180))
            phi = float(rng.uniform(-60, -10))
            c2w = pose_spherical(theta, phi, radius)
            img = _trace_sphere(H, W, focal, c2w)
            rel = f"./{split}/r_{i}"
            imwrite_png(os.path.join(out_dir, f"{split}/r_{i}.png"), img)
            frames.append({"file_path": rel, "transform_matrix": c2w.tolist()})
        meta = {"camera_angle_x": camera_angle_x, "frames": frames}
        with open(os.path.join(out_dir, f"transforms_{split}.json"), "w") as f:
            json.dump(meta, f)
    return out_dir


def make_icosphere(subdiv: int = 2, radius: float = 0.3):
    """Octahedron-subdivision sphere mesh -> (verts [V,3], faces [T,3])."""
    verts = np.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        np.float64,
    )
    faces = np.array(
        [[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
         [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]],
        np.int64,
    )
    for _ in range(subdiv):
        edge_mid = {}
        new_faces = []
        verts = list(verts)

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in edge_mid:
                m = (np.asarray(verts[i]) + np.asarray(verts[j])) / 2
                m = m / np.linalg.norm(m)
                edge_mid[key] = len(verts)
                verts.append(m)
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        verts = np.asarray(verts)
        faces = np.asarray(new_faces, np.int64)
    verts = verts / np.linalg.norm(verts, axis=-1, keepdims=True) * radius
    return verts.astype(np.float32), faces.astype(np.int32)


def make_synthetic_genebody(
    n_frames: int = 1,
    n_cams: int = 6,
    H: int = 64,
    W: int = 64,
    radius: float = 0.3,
    cam_dist: float = 2.0,
    seed: int = 0,
):
    """In-memory GeneBody-like arrays: an icosphere 'person' seen by a ring
    of OpenCV-convention (x_cam = R x + t, +z forward) pinhole cameras.
    Returns the ``arrays`` dict accepted by GeneBodyDataset."""
    rng = np.random.RandomState(seed)
    verts0, faces = make_icosphere(2, radius)

    focal = 0.9 * W
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)

    smpl_verts = np.stack(
        [verts0 + 0.02 * f * np.array([1.0, 0, 0], np.float32) for f in range(n_frames)]
    )
    w2cs = np.zeros((n_cams, 4, 4), np.float32)
    for c in range(n_cams):
        th = 2 * np.pi * c / n_cams
        pos = cam_dist * np.array([np.cos(th), np.sin(th), 0.2])
        fwd = -pos / np.linalg.norm(pos)  # camera +z looks at origin
        right = np.cross(fwd, [0, 0, 1.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd]).astype(np.float32)
        w2cs[c, :3, :3] = R
        w2cs[c, :3, 3] = -R @ pos
        w2cs[c, 3, 3] = 1.0

    imgs = np.zeros((n_frames, n_cams, H, W, 3), np.float32)
    masks = np.zeros((n_frames, n_cams, H, W), np.float32)
    depths = np.zeros((n_frames, n_cams, H, W), np.float32)
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    for f in range(n_frames):
        center = smpl_verts[f].mean(0)
        for c in range(n_cams):
            c2w = np.linalg.inv(w2cs[c])
            Rt, t = c2w[:3, :3], c2w[:3, 3]
            d_cam = np.stack(
                [(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1], np.ones_like(xs)],
                -1,
            )
            d = d_cam @ Rt.T
            o = np.broadcast_to(t, d.shape)
            dn = d / np.linalg.norm(d, axis=-1, keepdims=True)
            oc = o - center
            b = np.sum(oc * dn, -1)
            disc = b * b - (np.sum(oc * oc, -1) - radius**2)
            hit = disc > 0
            tt = -b - np.sqrt(np.maximum(disc, 0))
            hit &= tt > 0
            p = oc + tt[..., None] * dn
            rgb = np.clip(0.5 * (p / radius + 1.0), 0, 1)
            imgs[f, c] = np.where(hit[..., None], rgb, 0.0)
            masks[f, c] = hit.astype(np.float32)
            # camera-frame depth of the hit point (smpl_depth analog)
            zcam = (center + p) @ w2cs[c][2, :3] + w2cs[c][2, 3]
            depths[f, c] = np.where(hit, np.maximum(zcam, 0), 0.0)

    return {
        "imgs": imgs,
        "masks": masks,
        "K": np.stack([K] * n_cams),
        "w2c": w2cs,
        "smpl_verts": smpl_verts,
        "smpl_faces": faces,
        "smpl_t_verts": verts0,
        "smpl_rot": np.stack([np.eye(3, dtype=np.float32)] * n_frames),
        "smpl_depth": depths,
    }
