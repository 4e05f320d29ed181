"""PNG reading and writing with numpy and ``zlib`` — the port's image files
without ``imageio`` (the card's machine has neither ``imageio`` nor Pillow).

:func:`imread_png` reads non-interlaced PNGs of colour types 0 (grey), 2
(RGB), 3 (palette, at 1, 2, 4 or 8 bits), 4 (grey + alpha) and 6 (RGBA) at
bit depth 8, and grey at 16. It checks every chunk's CRC, joins the IDAT
chunks and undoes the row filters 0-4 in ``native/png_unfilter.cpp`` (built
with ``g++`` on first use; Average and Paeth are serial along a row). It
returns what ``np.asarray(imageio.v2.imread(path))`` returns through
Pillow: ``uint8`` [H, W] / [H, W, 2] / [H, W, 3] / [H, W, 4], ``uint16``
[H, W] for 16-bit grey, and a palette image as its [H, W, 3] RGB colours.
Pillow drops a palette's ``tRNS`` alpha there, so this reader does too; a
grey or RGB image's ``tRNS`` colour key is dropped in the same way. It
raises, naming the file and the reason, on Adam7 interlacing, on grey
below 8 bits, and on 16-bit colour (Pillow keeps only the high byte of
each 16-bit RGB, grey + alpha or RGBA sample, which is not the file's
value).

:func:`imwrite_png` writes ``uint8`` [H, W] / [H, W, 3] / [H, W, 4] and
``uint16`` [H, W] (a depth map) with filter 0 and ``zlib`` level 6.

:func:`imread` is the loaders' reader. It goes by a file's first bytes, not
its name: PNGs go through :func:`imread_png`, JPEGs through
``utils/jpeg.py:imread_jpeg`` (baseline and extended-sequential, without
``imageio`` or Pillow either); any other format goes through ``imageio``,
imported only then, and raises naming the file when it is missing.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from .jpeg import decode_jpeg

JPEG_SOI = b"\xff\xd8\xff"  # SOI and the first byte of the next marker
SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# colour type of a uint8 array by its channel count
_WRITE_TYPE = {1: 0, 3: 2, 4: 6}


def imread(path: str) -> np.ndarray:
    """An image file as an array: PNG through :func:`imread_png`, JPEG
    through ``imread_jpeg``, by their first bytes; anything else through
    ``imageio``."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == SIGNATURE:
        return decode_png(data, str(path))
    if data[:3] == JPEG_SOI:
        return decode_jpeg(data, str(path))
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise ModuleNotFoundError(f"reading {path} needs imageio (PNG and JPEG files are read without it)") from e
    return np.asarray(imageio.imread(path))


def imread_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read(), str(path))


def _chunks(data: bytes, name: str):
    """(type, body) of each chunk up to IEND, every CRC checked."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file (bad signature)")
    pos = 8
    while True:
        if pos + 12 > len(data):
            raise ValueError(f"{name}: truncated PNG (no IEND chunk)")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"{name}: truncated {ctype!r} chunk")
        body = data[pos + 8:end]
        if zlib.crc32(ctype + body) != struct.unpack(">I", data[end:end + 4])[0]:
            raise ValueError(f"{name}: CRC mismatch in the {ctype.decode('latin-1')} chunk")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = end + 4


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The array of a PNG file's bytes (see the module docstring)."""
    ihdr, plte, idat = None, None, []
    for ctype, body in _chunks(data, name):
        if ctype == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"{name}: IHDR of {len(body)} bytes (13 are defined)")
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            plte = body
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype != b"IEND" and not ctype[0] & 0x20:  # an unknown critical chunk
            raise ValueError(f"{name}: unsupported critical chunk {ctype.decode('latin-1')}")
    if ihdr is None:
        raise ValueError(f"{name}: no IHDR chunk")
    width, height, depth, color, compression, filter_method, interlace = ihdr
    if interlace != 0:
        raise ValueError(f"{name}: Adam7-interlaced PNGs are not supported")
    if compression != 0 or filter_method != 0 or color not in _CHANNELS:
        raise ValueError(f"{name}: invalid IHDR (colour type {color}, compression {compression}, "
                         f"filter method {filter_method})")
    if color == 3:
        if depth not in (1, 2, 4, 8):
            raise ValueError(f"{name}: invalid palette bit depth {depth}")
    elif depth < 8:
        raise ValueError(f"{name}: bit depth {depth} is not supported (only palette images go below 8)")
    elif depth == 16 and color != 0:
        raise ValueError(f"{name}: 16-bit colour (colour type {color}) is not supported")
    elif depth != 8 and not (depth == 16 and color == 0):
        raise ValueError(f"{name}: invalid bit depth {depth}")
    if not idat:
        raise ValueError(f"{name}: no IDAT chunk")

    channels = _CHANNELS[color]
    stride = (width * channels * depth + 7) // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt image data ({e})") from e
    if len(raw) != height * (stride + 1):
        raise ValueError(f"{name}: image data holds {len(raw)} bytes, expected {height * (stride + 1)}")
    rows = _unfilter(raw, height, stride, max(1, channels * depth // 8), name)

    if color == 3:
        if plte is None or len(plte) % 3:
            raise ValueError(f"{name}: palette image without a valid PLTE chunk")
        if depth < 8:
            bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
            idx = (bits.astype(np.uint16) << np.arange(depth - 1, -1, -1, dtype=np.uint16)).sum(-1)[:, :width]
        else:
            idx = rows
        palette = np.frombuffer(plte, np.uint8).reshape(-1, 3)
        if idx.max(initial=0) >= len(palette):
            raise ValueError(f"{name}: palette index {int(idx.max())} past the {len(palette)}-entry PLTE")
        return palette[idx]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(height, width)
    return rows.reshape((height, width) if channels == 1 else (height, width, channels))


def _unfilter(raw: bytes, height: int, stride: int, bpp: int, name: str) -> np.ndarray:
    """[height, stride] uint8 rows of the filtered scanlines ``raw``."""
    from ..native import load_png_unfilter

    src = np.frombuffer(raw, np.uint8)
    dst = np.empty((height, stride), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    bad = load_png_unfilter().png_unfilter(src.ctypes.data_as(u8p), dst.ctypes.data_as(u8p), height, stride, bpp)
    if bad:
        raise ValueError(f"{name}: row {bad - 1} has filter type {raw[(bad - 1) * (stride + 1)]} (0-4 are defined)")
    return dst


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def imwrite_png(path: str, img: np.ndarray) -> None:
    """Write a ``uint8`` [H, W] / [H, W, 3] / [H, W, 4] or ``uint16`` [H, W]
    array as one IDAT of filter-0 rows compressed at ``zlib`` level 6."""
    img = np.asarray(img)
    channels = 1 if img.ndim == 2 else img.shape[-1] if img.ndim == 3 else 0
    grey16 = img.dtype == np.uint16 and img.ndim == 2
    if not grey16 and (img.dtype != np.uint8 or channels not in _WRITE_TYPE):
        raise ValueError(f"imwrite_png takes uint8 [H, W], [H, W, 3], [H, W, 4] or uint16 [H, W], "
                         f"got {img.dtype} {img.shape}")
    height, width = img.shape[:2]
    data = img.astype(">u2").view(np.uint8) if grey16 else img
    rows = np.zeros((height, 1 + data[0].size), np.uint8)  # filter byte 0, then the row
    rows[:, 1:] = data.reshape(height, -1)
    ihdr = struct.pack(">IIBBBBB", width, height, 16 if grey16 else 8, _WRITE_TYPE[channels], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))
