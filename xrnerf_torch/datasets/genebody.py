"""GeneBody dataset for GNR — a numpy copy of
``xrnerf_tpu/datasets/genebody.py``: multi-view human captures with SMPL
fits. Per frame, ``num_views`` fixed source views and one query view;
mask-driven square cropping to ``load_size``; near/far from the SMPL
vertices' camera-depth span; ``spatial_freq`` from the SMPL reprojection;
per-view perspective params ``[fx, fy, cx, cy, near, far]`` and w2c
extrinsics; the SMPL mesh, its T-pose and global-orient rotation; the
rasterised SMPL depth when present.

Batches: ray segments ``rays_s`` / ``rays_e`` through pixels of the query
view's mask, with the frame's context in ``ctx_*`` keys. ``arrays=`` builds
the dataset in memory (tests, custom captures); otherwise it reads the
on-disk layout: images, masks and ``smpl_depth`` through
``utils/png.py:imread`` (PNG and JPEG without ``imageio``), the crops
resized by ``load/pil_resize.py`` (Pillow's bicubic and nearest, bit for
bit, without Pillow). The same files, arrays and step give the same arrays
and batches as the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from ..models.renders.gnr_render import rays_perspective_np
from ..registry import DATASETS
from ..utils.png import imread
from .load.pil_resize import resize_bicubic, resize_nearest


def image_cropping(mask: np.ndarray):
    """Square crop around the mask with 10% padding
    (genebody_dataset.py:116-158) -> (top, left, bottom, right)."""
    a = np.where(mask != 0)
    h, w = mask.shape[:2]
    if len(a[0]) == 0:
        return 0, 0, h, w
    top, left, bottom, right = np.min(a[0]), np.min(a[1]), np.max(a[0]), np.max(a[1])
    bbox_h, bbox_w = bottom - top, right - left
    bottom = min(int(bbox_h * 0.1 + bottom), h)
    top = max(int(top - bbox_h * 0.1), 0)
    right = min(int(bbox_w * 0.1 + right), w)
    left = max(int(left - bbox_h * 0.1), 0)
    bbox_h, bbox_w = bottom - top, right - left
    if bbox_h >= bbox_w:
        w_c = (left + right) / 2
        size = bbox_h
        if w_c - size / 2 < 0:
            left, right = 0, size
        elif w_c + size / 2 >= w:
            left, right = w - size, w
        else:
            left = int(w_c - size / 2)
            right = left + size
    else:
        h_c = (top + bottom) / 2
        size = bbox_w
        if h_c - size / 2 < 0:
            top, bottom = 0, size
        elif h_c + size / 2 >= h:
            top, bottom = h - size, h
        else:
            top = int(h_c - size / 2)
            bottom = top + size
    return top, left, bottom, right


def get_near_far(smpl_verts: np.ndarray, w2c: np.ndarray):
    """Camera-depth span of the SMPL verts, padded 50% each side."""
    vp = smpl_verts @ w2c[:3, :3].T + w2c[:3, 3]
    near, far = vp[:, 2].min(), vp[:, 2].max()
    half = (far - near) / 2
    return float(near - half), float(far + half)


def get_realworld_scale(smpl_verts, bbox_min, bbox_max, w2c, K):
    """spatial_freq: pixels-per-world-unit normalizer
    (genebody_dataset.py:167-183). bbox_* are (y, x) mins/maxes of the
    query mask in the resized image."""
    smpl_min, smpl_max = smpl_verts.min(0), smpl_verts.max(0)
    vp = smpl_verts @ w2c[:3, :3].T + w2c[:3, 3]
    vp = vp @ K.T
    vp = vp[:, :2] / (vp[:, 2:] + 1e-8)
    vmin, vmax = vp.min(0), vp.max(0)
    bbox_h = bbox_max[0] - bbox_min[0]
    bbox_w = bbox_max[1] - bbox_min[1]
    if bbox_h > bbox_w:
        long_axis = bbox_h / (vmax[1] - vmin[1]) * (smpl_max[1] - smpl_min[1])
    else:
        long_axis = bbox_w / (vmax[0] - vmin[0]) * (smpl_max[0] - smpl_min[0])
    return float(180.0 / long_axis / 0.5)


@DATASETS.register
class GeneBodyDataset:
    """In-memory arrays: imgs [F,C,H,W,3] in [0,1] (pre-cropped to
    load_size), masks [F,C,H,W], K [C,3,3], w2c [C,4,4], smpl_verts
    [F,Vs,3], smpl_faces [T,3], smpl_t_verts [Vs,3], smpl_rot [F,3,3],
    optional smpl_depth [F,C,H,W]."""

    def __init__(
        self,
        datadir: Optional[str] = None,
        subject: Optional[str] = None,
        arrays: Optional[Dict] = None,
        num_views: int = 4,
        input_views: Sequence[int] = (1, 13, 25, 37),
        N_rand: int = 1024,
        load_size: int = 512,
        frame_start: int = 0,
        frame_end: int = 10,
        frame_skip: int = 1,
        seed: int = 0,
    ):
        self.num_views = int(num_views)
        self.N_rand = int(N_rand)
        self.seed = seed

        if arrays is not None:
            self.imgs = arrays["imgs"].astype(np.float32)
            self.masks = arrays["masks"].astype(np.float32)
            self.Ks = arrays["K"].astype(np.float32)
            self.w2c = arrays["w2c"].astype(np.float32)
            self.smpl_verts = arrays["smpl_verts"].astype(np.float32)
            self.smpl_faces = arrays["smpl_faces"].astype(np.int32)
            self.smpl_t_verts = arrays["smpl_t_verts"].astype(np.float32)
            self.smpl_rot = arrays["smpl_rot"].astype(np.float32)
            self.smpl_depth = arrays.get("smpl_depth")
            self.load_size = self.imgs.shape[3]
        else:
            self.load_size = int(load_size)
            self._load_genebody(
                datadir, subject, frame_start, frame_end, frame_skip
            )

        f, c = self.imgs.shape[:2]
        self.n_frames, self.n_cams = f, c
        iv = [v for v in input_views if v < c][: self.num_views]
        while len(iv) < self.num_views:  # tiny test rigs reuse views
            iv.append(iv[len(iv) % max(len(iv), 1)])
        self.input_views = iv
        self.query_views = [v for v in range(c) if v not in iv] or iv[:1]
        self.test_pairs = [(fi, v) for fi in range(f) for v in self.query_views]
        self.i_val = np.arange(min(len(self.test_pairs), 2))
        self.i_test = np.arange(len(self.test_pairs))
        self.H = self.W = self.load_size

    # ------------------------------------------------------------------
    def _load_genebody(self, datadir, subject, f0, f1, skip):
        """Disk layout: root/subject/{annots.npy, image/<cam>/, mask/<cam>/,
        smpl_depth/<cam>/, param/, smpl/}; cams named '%02d'."""
        root = os.path.join(datadir, subject)
        annots = np.load(
            os.path.join(root, "annots.npy"), allow_pickle=True
        ).item()["cams"]
        cam_names = sorted(annots.keys()) if isinstance(annots, dict) else None

        def frame_list(cam):
            d = os.path.join(root, "image", cam)
            return sorted(os.listdir(d))[f0:f1:skip]

        cams = cam_names or ["%02d" % i for i in range(48)]
        frames = frame_list(cams[0])

        ls = self.load_size
        imgs = np.zeros((len(frames), len(cams), ls, ls, 3), np.float32)
        masks = np.zeros((len(frames), len(cams), ls, ls), np.float32)
        depths = np.zeros((len(frames), len(cams), ls, ls), np.float32)
        Ks = np.zeros((len(frames), len(cams), 3, 3), np.float32)
        w2cs = np.zeros((len(cams), 4, 4), np.float32)
        verts_l, rots_l = [], []

        for ci, cam in enumerate(cams):
            w2cs[ci] = np.linalg.inv(np.asarray(annots[cam]["c2w"], np.float32))
        for fi, frame in enumerate(frames):
            stem = os.path.splitext(frame)[0]
            # SMPL fit
            pdir = os.path.join(root, "param")
            ppath = [os.path.join(pdir, f) for f in os.listdir(pdir) if stem in f][0]
            param = np.load(ppath, allow_pickle=True).item()
            sdir = os.path.join(root, "smpl")
            spath = [os.path.join(sdir, f) for f in os.listdir(sdir) if stem in f][0]
            verts, faces = _load_obj(spath)
            verts_l.append(verts)
            go = np.asarray(param["smplx"]["global_orient"]).reshape(-1, 3)[0]
            rots_l.append(_rodrigues(go))
            if fi == 0:
                self.smpl_faces = faces.astype(np.int32)
            for ci, cam in enumerate(cams):
                img = imread(os.path.join(root, "image", cam, frame))
                mask_dir = os.path.join(root, "mask", cam)
                mpath = [
                    os.path.join(mask_dir, f)
                    for f in os.listdir(mask_dir)
                    if stem in f
                ][0]
                m = imread(mpath)
                if m.ndim == 3:
                    m = m[..., 0]
                t, l, b, r = image_cropping(m)
                img = resize_bicubic(img[t:b, l:r], (ls, ls))
                m = resize_nearest(m[t:b, l:r], (ls, ls))
                mask = (m > 128).astype(np.float32)
                imgs[fi, ci] = img[..., :3] / 255.0 * mask[..., None]
                masks[fi, ci] = mask
                K = np.asarray(annots[cam]["K"], np.float32).copy()
                K[0, 2] -= l
                K[1, 2] -= t
                K[0] *= ls / float(r - l)
                K[1] *= ls / float(b - t)
                Ks[fi, ci] = K
                ddir = os.path.join(root, "smpl_depth", cam)
                if os.path.isdir(ddir):
                    dpath = [
                        os.path.join(ddir, f)
                        for f in os.listdir(ddir)
                        if stem in f
                    ]
                    if dpath:
                        dep = imread(dpath[0]).astype(
                            np.float32
                        ) / 1000.0
                        dep = resize_nearest(dep[t:b, l:r], (ls, ls))
                        depths[fi, ci] = dep

        self.imgs, self.masks = imgs, masks
        self.Ks = Ks[0]  # per-frame K variation is tiny crop jitter; use frame 0
        self.w2c = w2cs
        self.smpl_verts = np.stack(verts_l)
        self.smpl_rot = np.stack(rots_l).astype(np.float32)
        self.smpl_depth = depths if depths.any() else None
        t_obj = os.path.join(datadir, "smpl_t_pose.obj")
        self.smpl_t_verts = (
            _load_obj(t_obj)[0] if os.path.exists(t_obj) else self.smpl_verts[0]
        )

    # ------------------------------------------------------------------
    def _persp(self, frame, view):
        K = self.Ks[view] if self.Ks.ndim == 3 else self.Ks[frame, view]
        near, far = get_near_far(self.smpl_verts[frame], self.w2c[view])
        return np.asarray(
            [K[0, 0], K[1, 1], K[0, 2], K[1, 2], near, far], np.float32
        )

    def _ctx(self, frame, qview):
        src = self.input_views
        persps = np.stack(
            [self._persp(frame, v) for v in src] + [self._persp(frame, qview)]
        )
        calibs = np.stack([self.w2c[v] for v in src] + [self.w2c[qview]])
        verts = self.smpl_verts[frame]
        # spatial_freq = min over source views (genebody_dataset.py:327)
        freqs = []
        for v in src:
            m = self.masks[frame, v]
            a = np.where(m > 0.5)
            if len(a[0]) == 0:
                continue
            K = self.Ks[v] if self.Ks.ndim == 3 else self.Ks[frame, v]
            freqs.append(
                get_realworld_scale(
                    verts,
                    (a[0].min(), a[1].min()),
                    (a[0].max(), a[1].max()),
                    self.w2c[v],
                    K,
                )
            )
        ctx = {
            "ctx_images": self.imgs[frame, src],
            "ctx_masks": self.masks[frame, src],
            "ctx_calibs": calibs,
            "ctx_persps": persps,
            "ctx_center": (verts.max(0) + verts.min(0)) / 2.0,
            "ctx_spatial_freq": np.asarray(min(freqs) if freqs else 1.0, np.float32),
            "ctx_smpl_verts": verts,
            "ctx_smpl_faces": self.smpl_faces,
            "ctx_smpl_t_verts": self.smpl_t_verts,
            "ctx_smpl_rot": self.smpl_rot[frame],
        }
        if self.smpl_depth is not None:
            ctx["ctx_smpl_depth"] = self.smpl_depth[frame, src]
        return ctx

    def train_batch(self, step: int, host_id: int = 0, num_hosts: int = 1) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState((self.seed + step) * num_hosts + host_id + 7)
        frame = rng.randint(self.n_frames)
        qview = self.query_views[rng.randint(len(self.query_views))]

        mask = self.masks[frame, qview]
        ys, xs = np.nonzero(mask > 0.5)
        if len(ys) == 0:
            ys, xs = np.nonzero(np.ones_like(mask))
        sel = rng.randint(len(ys), size=self.N_rand)
        pix = np.stack([xs[sel], ys[sel]], -1).astype(np.float32)

        persp = self._persp(frame, qview)
        rays_s, rays_e = rays_perspective_np(pix, self.w2c[qview], persp)
        batch = {
            "rays_s": rays_s,
            "rays_e": rays_e,
            "target": self.imgs[frame, qview][ys[sel], xs[sel]],
        }
        batch.update(self._ctx(frame, qview))
        return batch

    # ------------------------------------------------------------------
    def eval_item(self, item_i: int):
        frame, qview = self.test_pairs[item_i]
        xs, ys = np.meshgrid(np.arange(self.W), np.arange(self.H))
        pix = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)
        persp = self._persp(frame, qview)
        rays_s, rays_e = rays_perspective_np(pix, self.w2c[qview], persp)
        rays = {"rays_s": rays_s, "rays_e": rays_e}
        rays.update(self._ctx(frame, qview))
        return rays, self.imgs[frame, qview]

    def spiral_item(self, pose: np.ndarray):
        """Novel-view rays for a c2w pose (get_render_poses / move_cam
        free-viewpoint path): query camera uses view-0 intrinsics."""
        frame = 0
        w2c = np.linalg.inv(pose).astype(np.float32)
        K = self.Ks[self.input_views[0]] if self.Ks.ndim == 3 else self.Ks[0, 0]
        near, far = get_near_far(self.smpl_verts[frame], w2c)
        cam = np.asarray(
            [K[0, 0], K[1, 1], K[0, 2], K[1, 2], near, far], np.float32
        )
        xs, ys = np.meshgrid(np.arange(self.W), np.arange(self.H))
        pix = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)
        rays_s, rays_e = rays_perspective_np(pix, w2c, cam)
        rays = {"rays_s": rays_s, "rays_e": rays_e}
        ctx = self._ctx(frame, self.query_views[0])
        # query persp (last row) follows the novel camera
        ctx["ctx_persps"] = np.concatenate([ctx["ctx_persps"][:-1], cam[None]])
        rays.update(ctx)
        return rays, (self.H, self.W)

    @property
    def render_poses(self):
        """Circle of c2w poses around the frame-0 person center."""
        center = self.smpl_verts[0].mean(0)
        c2w0 = np.linalg.inv(self.w2c[self.input_views[0]])
        dist = np.linalg.norm(c2w0[:3, 3] - center)
        poses = []
        for th in np.linspace(0, 2 * np.pi, 21)[:-1]:
            pos = center + dist * np.array([np.cos(th), np.sin(th), 0.1])
            fwd = (center - pos) / np.linalg.norm(center - pos)
            right = np.cross(fwd, [0, 0, 1.0])
            right /= np.linalg.norm(right)
            down = np.cross(fwd, right)
            c2w = np.eye(4, dtype=np.float32)
            # w2c rows are (right, down, fwd); c2w is its inverse
            R = np.stack([right, down, fwd]).astype(np.float32)
            c2w[:3, :3] = R.T
            c2w[:3, 3] = pos
            poses.append(c2w)
        return np.stack(poses)

    @property
    def num_val(self):
        return len(self.i_val)

    @property
    def num_test(self):
        return len(self.i_test)


def _rodrigues(rvec: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(rvec) + 1e-12
    k = rvec / th
    K = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], np.float64
    )
    return (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(np.float32)


def _load_obj(path: str):
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:4]]
                faces.append(idx)
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)
