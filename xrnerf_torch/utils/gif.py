"""Animated GIF writing with numpy — ``SaveSpiralHook``'s gif where
``imageio`` is missing (the card's machine); an mp4 still needs ``imageio``
and ffmpeg.

:func:`write_gif` writes GIF89a: each frame with its own adaptive palette
of up to 256 colours (its own colours when there are no more; else a
median cut over the frame's colour histogram, each colour then given to its
nearest palette entry), LZW-coded at 8 bits, a delay of
``duration`` milliseconds (in the format's hundredths of a second, as
Pillow writes it) and a NETSCAPE2.0 block that loops the animation
forever, as ``imageio.mimwrite(path, frames, duration=...)`` asks Pillow
to.
"""

from __future__ import annotations

import struct
from typing import Sequence

import numpy as np

_COLOURS = 256


def _median_cut(colours: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Box id of each colour: the box with the most pixels times its widest
    channel range is cut at that channel's weighted median until there are
    256 boxes or none can be cut."""

    def entry(box):
        span = np.ptp(colours[box], axis=0)
        return int(counts[box].sum()) * int(span.max()), int(np.argmax(span)), box

    boxes = [entry(np.arange(len(colours)))]
    while len(boxes) < _COLOURS:
        i = max(range(len(boxes)), key=lambda j: boxes[j][0])
        score, ch, box = boxes[i]
        if score == 0:
            break
        order = box[np.argsort(colours[box, ch], kind="stable")]
        cum = np.cumsum(counts[order])
        cut = int(np.clip(np.searchsorted(cum, cum[-1] / 2) + 1, 1, len(order) - 1))
        boxes[i] = entry(order[:cut])
        boxes.append(entry(order[cut:]))
    label = np.empty(len(colours), np.int64)
    for j, (_, _, box) in enumerate(boxes):
        label[box] = j
    return label


def quantize(frame: np.ndarray):
    """(palette [256, 3] uint8, indices [H, W] uint8) of an RGB frame. A
    frame of at most 256 colours keeps them; otherwise the median cut runs
    over a 5-bit-per-channel histogram of the frame, each histogram cell goes
    to the palette colour nearest its mean, and each palette colour is then
    the mean of the pixels it was given."""
    pix = frame.reshape(-1, 3).astype(np.int64)
    palette = np.zeros((_COLOURS, 3), np.uint8)
    exact, inverse = np.unique(pix @ np.array([65536, 256, 1]), return_inverse=True)
    if len(exact) <= _COLOURS:
        palette[:len(exact)] = np.stack([exact >> 16, (exact >> 8) & 255, exact & 255], -1)
        return palette, inverse.reshape(frame.shape[:2]).astype(np.uint8)
    cells, inverse, counts = np.unique((pix >> 3) @ np.array([1024, 32, 1]), return_inverse=True,
                                       return_counts=True)
    inverse = inverse.reshape(-1)
    means = np.stack([np.bincount(inverse, pix[:, c], len(cells)) for c in range(3)], -1) / counts[:, None]
    label = np.arange(len(cells)) if len(cells) <= _COLOURS else _median_cut(means, counts)
    n = int(label.max()) + 1
    centres = np.stack([np.bincount(label, counts * means[:, c], n) for c in range(3)], -1)
    centres /= np.bincount(label, counts, n)[:, None]
    label = np.argmin(((means[:, None, :] - centres[None]) ** 2).sum(-1), axis=1)
    used = np.bincount(label, counts, n)
    sums = np.stack([np.bincount(label, counts * means[:, c], n) for c in range(3)], -1)
    centres = np.where(used[:, None] > 0, sums / np.maximum(used, 1)[:, None], centres)
    palette[:n] = np.clip(np.round(centres), 0, 255).astype(np.uint8)
    return palette, label[inverse].astype(np.uint8).reshape(frame.shape[:2])


def lzw(indices: np.ndarray, min_code_size: int = 8) -> bytes:
    """GIF's variable-length LZW code stream of the 8-bit ``indices``: a
    clear code first, codes widened as the table grows, a clear code when it
    holds 4096 entries, the end code last."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    acc = nbits = 0
    size, next_code, table = min_code_size + 1, end + 1, {}

    def emit(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    data = indices.reshape(-1).tolist()
    emit(clear)
    w = data[0]
    for k in data[1:]:
        key = (w << 8) | k
        code = table.get(key)
        if code is not None:
            w = code
            continue
        emit(w)
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            if next_code > (1 << size) and size < 12:
                size += 1
        else:
            emit(clear)
            table.clear()
            size, next_code = min_code_size + 1, end + 1
        w = k
    emit(w)
    emit(end)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255] for i in range(0, len(data), 255)) + b"\x00"


def write_gif(path: str, frames: Sequence[np.ndarray], duration: int, loop: int = 0) -> None:
    """Write ``uint8`` [H, W, 3] (or [H, W]) frames of one size as an
    animated GIF, ``duration`` milliseconds each."""
    frames = [np.asarray(f) for f in frames]
    if not frames or any(f.dtype != np.uint8 or f.shape[:2] != frames[0].shape[:2] for f in frames):
        raise ValueError("write_gif takes one or more uint8 frames of one size")
    h, w = frames[0].shape[:2]
    parts = [b"GIF89a", struct.pack("<HHBBB", w, h, 0x70, 0, 0),  # no global colour table
             b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"]
    for f in frames:
        rgb = np.repeat(f[..., None], 3, -1) if f.ndim == 2 else f[..., :3]
        palette, idx = quantize(np.ascontiguousarray(rgb))
        parts += [b"\x21\xf9\x04\x00" + struct.pack("<H", duration // 10) + b"\x00\x00",  # delay in 1/100 s
                  b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87),  # a local table of 256 colours
                  palette.tobytes(), b"\x08", _blocks(lzw(idx))]
    parts.append(b"\x3b")
    with open(path, "wb") as fh:
        fh.write(b"".join(parts))
