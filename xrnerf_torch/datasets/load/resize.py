"""Area-average downscaling in numpy, in place of ``cv2.resize(...,
interpolation=cv2.INTER_AREA)``, so the loaders need no ``cv2``.

An integer factor on both axes is a box mean over ``f_y x f_x`` blocks. Any
other factor weights each source pixel by the share of it that falls inside
the destination pixel's footprint, with OpenCV's tap tables (a tap whose
share is under 1e-3 is dropped, the last cell may be narrower), one axis at
a time: each source row is reduced along x, then the rows are summed along
y, in float32 and in the order OpenCV adds them, so ``uint8`` results round
the same way (to nearest, ties to even; a factor of exactly 2 on both axes
of a 1-, 3- or 4-channel ``uint8`` image rounds ties up, as OpenCV's fast
path does).
"""

from __future__ import annotations

import numpy as np


def _area_taps(src: int, dst: int):
    """OpenCV's ``computeResizeAreaTab`` as ([dst, taps] source index,
    [dst, taps] float32 weight); unused taps have weight 0 at index 0."""
    scale = src / dst
    rows = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        taps = []
        if s1 - f1 > 1e-3:
            taps.append((s1 - 1, (s1 - f1) / cell))
        taps += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            taps.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        rows.append(taps)
    n = max(len(t) for t in rows)
    idx = np.zeros((dst, n), np.int64)
    w = np.zeros((dst, n), np.float32)
    for d, taps in enumerate(rows):
        for k, (s, a) in enumerate(taps):
            idx[d, k], w[d, k] = s, np.float32(a)
    return idx, w


def _box(img: np.ndarray, H: int, W: int) -> np.ndarray:
    fy, fx = img.shape[0] // H, img.shape[1] // W
    blocks = img.reshape(H, fy, W, fx, *img.shape[2:])
    if img.dtype == np.uint8:
        s = blocks.astype(np.int64).sum(axis=(1, 3))
        if fy == fx == 2 and (img.ndim == 2 or img.shape[2] in (1, 3, 4)):
            return ((s + 2) >> 2).astype(np.uint8)
        mean = s.astype(np.float32) * np.float32(1.0 / (fy * fx))
        return np.clip(np.rint(mean), 0, 255).astype(np.uint8)
    return blocks.mean(axis=(1, 3), dtype=np.float64).astype(img.dtype)


def area_resize(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """Downscale ``img`` ([h, w] or [h, w, C], ``uint8`` or float) to
    ``[H, W(, C)]`` by area averaging, as ``cv2.INTER_AREA`` does."""
    h, w = img.shape[:2]
    if H > h or W > w:
        raise ValueError(f"area_resize only downscales: {(h, w)} -> {(H, W)}")
    if h % H == 0 and w % W == 0:
        return _box(img, H, W)
    yi, yw = _area_taps(h, H)
    xi, xw = _area_taps(w, W)
    x = img.astype(np.float32)
    tail = (1,) * (img.ndim - 2)
    # along x: each row's taps in order, f32 products added left to right
    rows = np.zeros((h, W) + img.shape[2:], np.float32)
    for k in range(xi.shape[1]):
        rows += x[:, xi[:, k]] * xw[:, k].reshape((1, W) + tail)
    # along y: the reduced rows weighted and added in order
    out = np.zeros((H, W) + img.shape[2:], np.float32)
    for k in range(yi.shape[1]):
        out += yw[:, k].reshape((H, 1) + tail) * rows[yi[:, k]]
    if img.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(img.dtype)
