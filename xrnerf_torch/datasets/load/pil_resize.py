"""Pillow's ``Image.resize`` in numpy, for the GeneBody loader's crops, so
the loaders need no Pillow: ``BICUBIC`` on ``uint8`` images of modes L, LA,
RGB and RGBA, and ``NEAREST`` on any [H, W] or [H, W, C] array (modes L and F
among them), bit for bit with Pillow 12 (``libImaging/Resample.c``,
``Geometry.c`` and ``Convert.c``), with no ``box`` and no ``reducing_gap``.

Bicubic (``a = -0.5``) computes each output pixel's taps in double, with the
filter's support widened by the scale when downscaling, normalises them,
makes them fixed point with ``PRECISION_BITS`` = 32 - 8 - 2 (rounded half
away from zero) and sums integer products from a half-unit start; a result
is clipped to 0-255 after each pass. The horizontal pass runs first, then
the vertical one; a pass whose size does not change is skipped. Nearest
takes the source pixel under each output pixel's centre: Pillow steps the
position by the scale, adding it once per pixel, and truncates it (an
output pixel whose position falls outside the image is 0). With an alpha channel (LA, RGBA)
the bicubic resize runs on the premultiplied image (La, RGBa): each colour
times alpha / 255, rounded as ``MULDIV255`` rounds; afterwards a colour is
divided back, ``255 * c // alpha`` clipped to 255, where alpha is neither 0
nor 255.
"""

from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coeffs(in_size: int, out_size: int):
    """``precompute_coeffs`` and ``normalize_coeffs_8bpc``: ([out, k] source
    index, [out, k] int64 fixed-point weight); taps past a pixel's bounds
    have weight 0 (and index 0)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = _bicubic((np.arange(xmax) + xmin - center + 0.5) * ss)
        ww = 0.0
        for v in w:  # summed in order, as the C loop does
            ww += v
        if ww != 0.0:
            w = w / ww
        kk[xx, :xmax] = w
        idx[xx, :xmax] = np.arange(xmin, xmin + xmax)
    scaled = kk * (1 << PRECISION_BITS)
    fixed = np.where(kk < 0, -0.5 + scaled, 0.5 + scaled).astype(np.int64)  # C's (int) truncates
    return idx, fixed


def _clip8(acc: np.ndarray) -> np.ndarray:
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _pass(img: np.ndarray, idx: np.ndarray, weights: np.ndarray, axis: int) -> np.ndarray:
    acc = np.int64(1 << (PRECISION_BITS - 1))
    for k in range(idx.shape[1]):
        w = weights[:, k]
        shape = [1] * img.ndim
        shape[axis] = -1
        acc = acc + np.take(img, idx[:, k], axis=axis).astype(np.int64) * w.reshape(shape)
    return _clip8(acc)


def _premultiply(img: np.ndarray) -> np.ndarray:
    """``rgbA2rgba``: RGBA -> RGBa (and LA -> La)."""
    tmp = img[..., :-1].astype(np.uint32) * img[..., -1:] + 128
    return np.concatenate([(((tmp >> 8) + tmp) >> 8).astype(np.uint8), img[..., -1:]], axis=-1)


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    """``rgba2rgbA``: RGBa -> RGBA (and La -> LA)."""
    alpha = img[..., -1:].astype(np.uint32)
    div = np.minimum(255 * img[..., :-1].astype(np.uint32) // np.maximum(alpha, 1), 255)
    colour = np.where((alpha == 0) | (alpha == 255), img[..., :-1], div).astype(np.uint8)
    return np.concatenate([colour, img[..., -1:]], axis=-1)


def resize_bicubic(img: np.ndarray, size) -> np.ndarray:
    """``Image.fromarray(img).resize(size, Image.BICUBIC)`` for a ``uint8``
    [H, W] or [H, W, C] array, C in 2 (LA), 3 (RGB) or 4 (RGBA); ``size`` is
    (width, height) as Pillow's."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[-1] in (2, 3, 4))):
        raise ValueError(f"resize_bicubic takes uint8 [H, W] or [H, W, 2|3|4] images, got {img.dtype} {img.shape}")
    (out_w, out_h), (in_h, in_w) = size, img.shape[:2]
    if (out_w, out_h) == (in_w, in_h):
        return img.copy()
    alpha = img.ndim == 3 and img.shape[-1] in (2, 4)
    out = _premultiply(img) if alpha else img
    if out_w != in_w:
        out = _pass(out, *_coeffs(in_w, out_w), axis=1)
    if out_h != in_h:
        out = _pass(out, *_coeffs(in_h, out_h), axis=0)
    return _unpremultiply(out) if alpha else out


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """``ImagingScaleAffine``'s source index of each output pixel, -1 outside."""
    step = in_size / out_size
    pos = np.cumsum(np.concatenate([[step * 0.5], np.full(out_size - 1, step)]))  # added one step at a time
    idx = pos.astype(np.int64)
    return np.where((pos < 0.0) | (idx >= in_size), -1, idx)


def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """``Image.fromarray(img).resize(size, Image.NEAREST)`` for an [H, W] or
    [H, W, C] array of any dtype; ``size`` is (width, height)."""
    img = np.asarray(img)
    (out_w, out_h), (in_h, in_w) = size, img.shape[:2]
    if (out_w, out_h) == (in_w, in_h):
        return img.copy()
    ys, xs = _nearest_index(in_h, out_h), _nearest_index(in_w, out_w)
    out = img[ys[:, None], xs[None, :]]
    out[(ys < 0)[:, None] | (xs < 0)[None, :]] = 0
    return out
