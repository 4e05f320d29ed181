"""NeuralBody dataset (ZJU-MoCap multi-view human capture) — a copy of
``xrnerf_tpu/datasets/neuralbody.py``: ``x_cam = R x + T`` pinhole rays
(``rays_from_KRT``), per-ray near/far from the person box
(``aabb_near_far``), training pixels drawn ``body_frac`` from the mask and
the rest from the mask's 2D box with the JAX package's ``RandomState``
seeds and draw order, and the per-frame context (``ctx_verts``,
``ctx_frame_idx``, ``ctx_bmin``, ``ctx_bmax``) that the renderer hands to
every chunk whole.

Layout (standard ZJU-MoCap):
  annots.npy            {'cams': {'K','R','T','D'}, 'ims': [{'ims': [paths]}]}
  <img paths>           per-frame per-cam images
  mask/ or mask_cihp/   segmentation masks mirroring image paths
  new_vertices/{i}.npy  posed SMPL vertices [6890, 3]

An ``arrays=`` constructor takes the same data in memory
(``load/synthetic.py:make_synthetic_zju``). Images and masks are read by
``utils/png.py:imread``: PNGs and JPEGs without ``imageio`` (other formats
through it).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..registry import DATASETS
from ..utils.png import imread


def rays_from_KRT(H, W, K, R, T, pix=None):
    """World-frame rays for x_cam = R x + T cameras. pix: [P,2] (x,y)."""
    if pix is None:
        xs, ys = np.meshgrid(np.arange(W), np.arange(H))
        pix = np.stack([xs, ys], -1).reshape(-1, 2)
    homo = np.concatenate([pix + 0.5, np.ones((pix.shape[0], 1))], -1)
    d_cam = homo @ np.linalg.inv(K).T
    rays_d = (d_cam @ R).astype(np.float32)  # R^T d
    rays_o = np.broadcast_to((-R.T @ T).reshape(1, 3), rays_d.shape).astype(np.float32)
    return rays_o, rays_d


def aabb_near_far(rays_o, rays_d, bmin, bmax, pad=0.05):
    """Slab intersection; rays that miss get near=far (zero span)."""
    inv = 1.0 / np.where(np.abs(rays_d) > 1e-10, rays_d, 1e-10)
    t0 = (bmin - pad - rays_o) * inv
    t1 = (bmax + pad - rays_o) * inv
    near = np.maximum(np.max(np.minimum(t0, t1), -1), 0.0)
    far = np.min(np.maximum(t0, t1), -1)
    far = np.maximum(far, near)
    return near[..., None].astype(np.float32), far[..., None].astype(np.float32)


@DATASETS.register
class NeuralBodyDataset:
    def __init__(
        self,
        datadir: Optional[str] = None,
        training_view=(0, 6, 12, 18),
        test_view=(),
        frame_start: int = 0,
        frame_end: int = 60,
        frame_skip: int = 1,
        N_rand: int = 1024,
        body_frac: float = 0.5,
        mask_dir: str = "mask_cihp",
        vertices_dir: str = "new_vertices",
        arrays: Optional[Dict] = None,
        seed: int = 0,
    ):
        self.N_rand = int(N_rand)
        self.body_frac = body_frac
        self.seed = seed

        if arrays is not None:
            # in-memory: imgs [F, C, H, W, 3], masks [F, C, H, W],
            # K/R/T [C, ...], verts [F, V, 3]
            self.imgs = arrays["imgs"].astype(np.float32)
            self.masks = arrays["masks"].astype(np.float32)
            self.Ks = arrays["K"]
            self.Rs = arrays["R"]
            self.Ts = arrays["T"]
            self.verts = arrays["verts"].astype(np.float32)
        else:
            self._load_zju(
                datadir, frame_start, frame_end, frame_skip, mask_dir, vertices_dir
            )

        f, c = self.imgs.shape[:2]
        self.n_frames, self.n_cams = f, c
        tv = [v for v in training_view if v < c]
        self.train_pairs = [(i, v) for i in range(f) for v in tv]
        te = [v for v in (test_view or [x for x in range(c) if x not in tv])]
        self.test_pairs = [(i, v) for i in range(f) for v in te] or self.train_pairs[:1]
        self.i_val = np.arange(min(len(self.test_pairs), 4))
        self.i_test = np.arange(len(self.test_pairs))
        self.H, self.W = self.imgs.shape[2:4]

    # ------------------------------------------------------------------
    def _load_zju(self, datadir, f0, f1, skip, mask_dir, vertices_dir):
        annots = np.load(os.path.join(datadir, "annots.npy"), allow_pickle=True).item()
        cams = annots["cams"]
        Ks = np.asarray(cams["K"], np.float32)
        Rs = np.asarray(cams["R"], np.float32)
        Ts = np.asarray(cams["T"], np.float32).reshape(len(Ks), 3) / 1000.0
        ims = annots["ims"][f0:f1:skip]

        imgs, masks, verts = [], [], []
        for fi, frame in enumerate(ims):
            paths = frame["ims"]
            frame_imgs, frame_masks = [], []
            for p in paths:
                img = imread(os.path.join(datadir, p)) / 255.0
                mpath = os.path.join(datadir, mask_dir, p.replace(".jpg", ".png"))
                if not os.path.exists(mpath):
                    mpath = os.path.join(datadir, "mask", p.replace(".jpg", ".png"))
                m = (imread(mpath) > 0).astype(np.float32)
                if m.ndim == 3:
                    m = m[..., 0]
                frame_imgs.append((img[..., :3] * m[..., None]).astype(np.float32))
                frame_masks.append(m)
            imgs.append(np.stack(frame_imgs))
            masks.append(np.stack(frame_masks))
            idx = f0 + fi * skip
            verts.append(
                np.load(os.path.join(datadir, vertices_dir, f"{idx}.npy")).astype(
                    np.float32
                )
            )
        self.imgs = np.stack(imgs)
        self.masks = np.stack(masks)
        self.Ks, self.Rs, self.Ts = Ks, Rs, Ts
        self.verts = np.stack(verts)

    # ------------------------------------------------------------------
    def _bounds(self, frame):
        v = self.verts[frame]
        return v.min(0) - 0.1, v.max(0) + 0.1

    def _ctx(self, frame):
        bmin, bmax = self._bounds(frame)
        return {
            "ctx_verts": self.verts[frame],
            "ctx_frame_idx": np.asarray(frame, np.int32),
            "ctx_bmin": bmin.astype(np.float32),
            "ctx_bmax": bmax.astype(np.float32),
        }

    def train_batch(self, step: int, host_id: int = 0, num_hosts: int = 1) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState((self.seed + step) * num_hosts + host_id + 31)
        frame, cam = self.train_pairs[rng.randint(len(self.train_pairs))]
        img = self.imgs[frame, cam]
        mask = self.masks[frame, cam]

        n_body = int(self.N_rand * self.body_frac)
        ys, xs = np.nonzero(mask > 0.5)
        if len(ys) == 0:
            ys, xs = np.nonzero(np.ones_like(mask))
        sel_b = rng.randint(len(ys), size=n_body)
        # bbox-region pixels for the remainder
        y0, y1 = ys.min(), ys.max() + 1
        x0, x1 = xs.min(), xs.max() + 1
        n_box = self.N_rand - n_body
        by = rng.randint(y0, y1, size=n_box)
        bx = rng.randint(x0, x1, size=n_box)
        pix = np.stack(
            [np.concatenate([xs[sel_b], bx]), np.concatenate([ys[sel_b], by])], -1
        )

        rays_o, rays_d = rays_from_KRT(
            self.H, self.W, self.Ks[cam], self.Rs[cam], self.Ts[cam], pix
        )
        bmin, bmax = self._bounds(frame)
        near, far = aabb_near_far(rays_o, rays_d, bmin, bmax)
        batch = {
            "rays_o": rays_o,
            "rays_d": rays_d,
            "near": near,
            "far": far,
            "target": img[pix[:, 1], pix[:, 0]].astype(np.float32),
            "mask": mask[pix[:, 1], pix[:, 0], None].astype(np.float32),
        }
        batch.update(self._ctx(frame))
        return batch

    # ------------------------------------------------------------------
    def eval_item(self, item_i: int):
        frame, cam = self.test_pairs[item_i]
        rays_o, rays_d = rays_from_KRT(
            self.H, self.W, self.Ks[cam], self.Rs[cam], self.Ts[cam]
        )
        bmin, bmax = self._bounds(frame)
        near, far = aabb_near_far(rays_o, rays_d, bmin, bmax)
        rays = {"rays_o": rays_o, "rays_d": rays_d, "near": near, "far": far}
        rays.update(self._ctx(frame))
        return rays, self.imgs[frame, cam]

    def spiral_item(self, pose: np.ndarray):
        # novel view: use cam-0 intrinsics with the given c2w pose
        R = pose[:3, :3].T
        T = -R @ pose[:3, 3]
        rays_o, rays_d = rays_from_KRT(self.H, self.W, self.Ks[0], R, T)
        bmin, bmax = self._bounds(0)
        near, far = aabb_near_far(rays_o, rays_d, bmin, bmax)
        rays = {"rays_o": rays_o, "rays_d": rays_d, "near": near, "far": far}
        rays.update(self._ctx(0))
        return rays, (self.H, self.W)

    @property
    def render_poses(self):
        # circle of novel views around the frame-0 person center
        from .rays import pose_spherical

        center = self.verts[0].mean(0)
        poses = []
        for th in np.linspace(-180, 180, 21)[:-1]:
            p = pose_spherical(th, -15.0, 2.5)
            p = p.copy()
            p[:3, 3] += center
            poses.append(p)
        return np.stack(poses)
