"""JPEG reading with numpy and ``native/jpeg_decode.cpp`` — the port's JPEG
images without ``imageio`` or Pillow (the card's machine has neither).

:func:`decode_jpeg` reads baseline and extended-sequential Huffman JPEGs
(SOF0, SOF1) of 8-bit samples with one (grey) or three components, at any
integral sampling factors, with or without restart intervals, in one
interleaved scan or one scan per component. It parses the markers here (APPn
and COM are skipped, EXIF included: ``imageio.v2.imread`` does not rotate
either), checks lengths and table ids, and hands each scan's entropy-coded
bytes and tables to the C++ decoder (built with ``g++`` on first use), which
also runs the pixel stages. It returns what ``np.asarray(imageio.v2.imread
(path))`` returns through Pillow and libjpeg-turbo's defaults (islow IDCT,
fancy upsampling, the fixed-point YCbCr -> RGB tables), bit for bit:
``uint8`` [H, W] for grey, [H, W, 3] for colour. Three components are RGB
as libjpeg decides it (an Adobe APP14 marker of transform 0 without a JFIF
marker, or component ids 'R', 'G', 'B'), else YCbCr.

It raises ``ValueError``, naming the file and the reason, on progressive,
lossless, hierarchical and arithmetic-coded files, on samples of other than
8 bits, on four components (CMYK, YCCK), on a missing Huffman or
quantisation table (libjpeg-turbo would use the standard Huffman tables of
a Motion-JPEG frame) and on truncated or corrupt data. Nothing is handed to
``imageio`` instead.
"""

from __future__ import annotations

import ctypes
import re
import struct

import numpy as np

SOI = b"\xff\xd8"
_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14,
    21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60,
    61, 54, 47, 55, 62, 63])
_REFUSED = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical progressive",
            0xC7: "hierarchical lossless", 0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
            0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
            0xCE: "arithmetic-coded hierarchical progressive", 0xCF: "arithmetic-coded hierarchical lossless"}
_SCAN_STATUS = {1: "truncated data (the scan ends before its last MCU)", 2: "corrupt data (no Huffman code matches)",
                3: "corrupt data (a restart marker is missing or out of order)"}
_MARKER = re.compile(rb"\xff[^\x00]")  # a marker or fill byte inside entropy-coded data


class _Frame:
    def __init__(self, width, height, ids, sampling, qt_ids):
        self.width, self.height = width, height
        self.ids, self.sampling, self.qt_ids = ids, sampling, qt_ids
        self.hmax = max(h for h, _ in sampling)
        self.vmax = max(v for _, v in sampling)
        mcux, mcuy = -(-width // (8 * self.hmax)), -(-height // (8 * self.vmax))
        # every component's [mcuy * v][mcux * h][64] block plane, back to back
        self.coefs = np.zeros(sum(mcuy * v * mcux * h * 64 for h, v in sampling), np.int16)
        self.desc = np.array([width, height, len(ids)] + [x for hv in sampling for x in hv], np.int32)
        self.quant = np.zeros((len(ids), 64), np.int32)
        self.scanned = [False] * len(ids)


def imread_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), str(path))


def _segment(data: bytes, pos: int, name: str):
    """(marker, body, next position) of the marker segment whose FF is at
    or after ``pos`` (bytes before it are skipped, as libjpeg does)."""
    start = data.find(b"\xff", pos)
    while start >= 0 and start + 1 < len(data) and data[start + 1] == 0xFF:  # fill bytes
        start += 1
    if start < 0 or start + 1 >= len(data):
        raise ValueError(f"{name}: truncated JPEG (no EOI marker)")
    marker = data[start + 1]
    if marker in (0x01, 0xD9) or 0xD0 <= marker <= 0xD7:  # TEM, EOI, RSTn: no length
        return marker, b"", start + 2
    if start + 4 > len(data):
        raise ValueError(f"{name}: truncated JPEG (marker FF{marker:02X} without its length)")
    length = struct.unpack(">H", data[start + 2:start + 4])[0]
    end = start + 2 + length
    if length < 2 or end > len(data):
        raise ValueError(f"{name}: truncated JPEG (marker FF{marker:02X} of length {length} past the data)")
    return marker, data[start + 4:end], end


def _dqt(body: bytes, tables: dict, name: str):
    pos = 0
    while pos < len(body):
        pq, tq = body[pos] >> 4, body[pos] & 15
        size = 64 * (pq + 1)
        if pq > 1 or tq > 3:
            raise ValueError(f"{name}: DQT table {tq} of precision {pq} (ids 0-3, precision 0 or 1)")
        if pos + 1 + size > len(body):
            raise ValueError(f"{name}: DQT segment too short for table {tq}")
        zigzag = np.frombuffer(body, ">u2" if pq else np.uint8, 64, pos + 1).astype(np.uint16)
        natural = np.zeros(64, np.uint16)
        natural[_NATURAL] = zigzag
        tables[tq] = natural.view(np.int16).astype(np.int32)  # libjpeg-turbo multiplies by 16-bit values
        pos += 1 + size


def _dht(body: bytes, tables: dict, name: str):
    pos = 0
    while pos < len(body):
        if pos + 17 > len(body):
            raise ValueError(f"{name}: DHT segment too short")
        tc, th = body[pos] >> 4, body[pos] & 15
        counts = body[pos + 1:pos + 17]
        n = sum(counts)
        if tc > 1 or th > 3 or n > 256 or pos + 17 + n > len(body):
            raise ValueError(f"{name}: invalid DHT table (class {tc}, id {th}, {n} symbols)")
        table = np.zeros(272, np.uint8)
        table[:16] = np.frombuffer(counts, np.uint8)
        table[16:16 + n] = np.frombuffer(body, np.uint8, n, pos + 17)
        tables[(tc, th)] = table
        pos += 17 + n


def _check_huffman(table: np.ndarray, dc: bool, tid: int, name: str):
    """jdhuff.c's checks: no code runs out of its length, DC symbols <= 15."""
    code = 0
    for length in range(1, 17):
        code += int(table[length - 1])
        if code >= (1 << length):  # the all-ones code of a length is not allowed
            raise ValueError(f"{name}: bad Huffman table ({'DC' if dc else 'AC'} {tid})")
        code <<= 1
    if dc and (table[16:16 + int(table[:16].sum())] > 15).any():
        raise ValueError(f"{name}: bad Huffman table (DC {tid} has a symbol over 15)")


def _sof(marker: int, body: bytes, name: str) -> _Frame:
    if marker in _REFUSED:
        raise ValueError(f"{name}: {_REFUSED[marker]} JPEGs are not supported (baseline and extended-sequential "
                         f"Huffman only)")
    if len(body) < 6:
        raise ValueError(f"{name}: SOF segment too short")
    precision, height, width, nc = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        raise ValueError(f"{name}: {precision}-bit samples are not supported (8-bit only)")
    if nc == 4:
        raise ValueError(f"{name}: four-component (CMYK or YCCK) JPEGs are not supported")
    if nc not in (1, 3) or len(body) != 6 + 3 * nc:
        raise ValueError(f"{name}: SOF of {nc} components in {len(body)} bytes (1 or 3 components are supported)")
    if height == 0 or width == 0:
        raise ValueError(f"{name}: image of {width}x{height} (a DNL marker's height is not supported)")
    ids, sampling, qt_ids = [], [], []
    for c in range(nc):
        cid, hv, tq = body[6 + 3 * c:9 + 3 * c]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
            raise ValueError(f"{name}: component {cid} has sampling {h}x{v} or table {tq}")
        ids.append(cid)
        sampling.append((h, v))
        qt_ids.append(tq)
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    if any(hmax % h or vmax % v for h, v in sampling):
        raise ValueError(f"{name}: fractional sampling {sampling} is not supported (libjpeg refuses it too)")
    return _Frame(width, height, ids, sampling, qt_ids)


def _scan(data: bytes, body: bytes, start: int, frame: _Frame, qt: dict, huff: dict, name: str):
    """The scan whose header is ``body`` and whose data starts at ``start``:
    the end of its data (the marker after it), its (component, DC table,
    AC table) rows and its [8, 272] Huffman tables for the decoder."""
    if frame is None:
        raise ValueError(f"{name}: SOS before SOF")
    ns = body[0] if body else 0
    if not 1 <= ns <= len(frame.ids) or len(body) != 4 + 2 * ns:
        raise ValueError(f"{name}: SOS of {ns} components in {len(body)} bytes")
    comps, rows, tables = [], [], np.zeros((8, 272), np.uint8)
    for i in range(ns):
        cid, t = body[1 + 2 * i], body[2 + 2 * i]
        idx = next((c for c, x in enumerate(frame.ids) if x == cid and c not in comps), None)
        td, ta = t >> 4, t & 15
        if idx is None or frame.scanned[idx] or td > 3 or ta > 3:
            raise ValueError(f"{name}: SOS names component {cid} (tables {td}, {ta}) that is unknown, "
                             f"scanned already, or out of range")
        for cls, tid in ((0, td), (1, ta)):  # DC, AC
            if (cls, tid) not in huff:
                raise ValueError(f"{name}: no {'AC' if cls else 'DC'} Huffman table {tid} defined")
            _check_huffman(huff[(cls, tid)], not cls, tid, name)
            tables[4 * cls + tid] = huff[(cls, tid)]
        if frame.qt_ids[idx] not in qt:
            raise ValueError(f"{name}: no quantisation table {frame.qt_ids[idx]} defined")
        frame.quant[idx] = qt[frame.qt_ids[idx]]  # latched when the component's scan starts, as libjpeg does
        frame.scanned[idx] = True
        comps.append(idx)
        rows.append((idx, td, ta))
    if ns > 1 and sum(frame.sampling[c][0] * frame.sampling[c][1] for c in comps) > 10:
        raise ValueError(f"{name}: an MCU of more than 10 blocks")
    # the entropy-coded data runs to the first marker that is not RSTn
    end = start
    while True:
        m = _MARKER.search(data, end)
        if m is None:
            raise ValueError(f"{name}: truncated JPEG (the scan has no end marker)")
        end = m.start()
        nxt = end + 1
        while nxt < len(data) and data[nxt] == 0xFF:
            nxt += 1
        if nxt < len(data) and 0xD0 <= data[nxt] <= 0xD7:
            end = nxt + 1
            continue
        break
    return end, np.array(rows, np.int32), tables


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The array of a JPEG file's bytes (see the module docstring)."""
    from ..native import load_jpeg_decoder

    if data[:2] != SOI:
        raise ValueError(f"{name}: not a JPEG file (no SOI marker)")
    qt, huff, restart, frame = {}, {}, 0, None
    jfif, adobe = False, None
    pos = 2
    buf = np.frombuffer(data, np.uint8)
    while True:
        marker, body, pos = _segment(data, pos, name)
        if marker == 0xD9:
            break
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if frame is not None:
                raise ValueError(f"{name}: a second SOF marker")
            frame = _sof(marker, body, name)
        elif marker == 0xDB:
            _dqt(body, qt, name)
        elif marker == 0xC4:
            _dht(body, huff, name)
        elif marker == 0xDD:
            if len(body) != 2:
                raise ValueError(f"{name}: DRI segment of {len(body)} bytes")
            restart = struct.unpack(">H", body)[0]
        elif marker == 0xDA:
            end, scan_desc, tables = _scan(data, body, pos, frame, qt, huff, name)
            status = load_jpeg_decoder().jpeg_decode_scan(
                ctypes.cast(buf.ctypes.data + pos, ctypes.POINTER(ctypes.c_uint8)), end - pos,
                _ptr(frame.desc, ctypes.c_int32), _ptr(scan_desc, ctypes.c_int32), len(scan_desc),
                _ptr(tables, ctypes.c_uint8), restart, _ptr(frame.coefs, ctypes.c_int16))
            if status:
                raise ValueError(f"{name}: {_SCAN_STATUS[status]}")
            pos = end
        elif marker == 0xE0 and body[:5] == b"JFIF\x00" and len(body) >= 14:
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker in (0xC8, 0xD8, 0xDC, 0xDE, 0xDF) or 0xF0 <= marker <= 0xFD:
            raise ValueError(f"{name}: unsupported marker FF{marker:02X}")
        # other APPn, COM, DAC, TEM and stray RSTn are skipped
    if frame is None:
        raise ValueError(f"{name}: no SOF marker")
    if not all(frame.scanned):
        raise ValueError(f"{name}: component {frame.ids[frame.scanned.index(False)]} is in no scan")
    ycc = 0
    if len(frame.ids) == 3:
        rgb = (not jfif and adobe == 0) or (not jfif and adobe is None and frame.ids == [82, 71, 66])
        ycc = 0 if rgb else 1
    out = np.empty((frame.height, frame.width, len(frame.ids)), np.uint8)
    load_jpeg_decoder().jpeg_pixels(_ptr(frame.desc, ctypes.c_int32), _ptr(frame.coefs, ctypes.c_int16),
                                    _ptr(frame.quant, ctypes.c_int32), ycc, _ptr(out, ctypes.c_uint8))
    return out[..., 0] if len(frame.ids) == 1 else out


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))

