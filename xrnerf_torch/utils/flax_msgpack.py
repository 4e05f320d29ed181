"""flax's msgpack checkpoint format in numpy and the standard library — the
JAX package's ``ckpt_N.msgpack`` files (``flax.serialization.
msgpack_serialize`` of plain nested dicts) on a machine without ``msgpack``
or flax.

:func:`unpackb` decodes the msgpack subset that flax writes: nil, bool, the
int and float widths, str, bin, array and map in every length class, and
ext in every length class with flax's three ext types: 1 an ndarray (a
packed ``(shape, dtype name, C-order bytes)``), 2 a Python complex (a packed
``(real, imag)``) and 3 a numpy scalar (an ndarray of shape ``()``).
Arrays too large for one msgpack object are maps ``{"__msgpack_chunked_array__":
True, "shape": {...}, "chunks": {...}}`` (flax's ``_chunk``); they are
joined back into one array where flax's ``msgpack_restore`` joins them (the
top level and any map's values). numpy has no ``bfloat16``, so a
``bfloat16`` array or scalar is widened exactly to ``float32`` (its 16 bits
become the high half of a float32); any other dtype name numpy does not
know raises, naming it. Arrays decode as read-only views of the input, as
flax's do.

:func:`packb` is the inverse: the bytes ``msgpack_serialize`` writes for a
tree of dicts, lists, numpy arrays and scalars, Python scalars, str, bytes
and None (tuples raise, as under flax's ``strict_types``), with arrays over
:data:`MAX_CHUNK_SIZE` bytes chunked as flax chunks them. It writes files
in the JAX package's checkpoint format; the port's trainer keeps writing
``.pt``.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

# flax's limit for one array leaf's bytes before it is chunked (flax/serialization.py)
MAX_CHUNK_SIZE = 2**30
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3

# fixed-width payloads by first byte: (struct format, size)
_FIXED = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# first byte -> byte count of the length that follows
_STR = {0xD9: 1, 0xDA: 2, 0xDB: 4}
_BIN = {0xC4: 1, 0xC5: 2, 0xC6: 4}
_ARRAY = {0xDC: 2, 0xDD: 4}
_MAP = {0xDE: 2, 0xDF: 4}
_EXT = {0xC7: 1, 0xC8: 2, 0xC9: 4}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_UINT = {1: ">B", 2: ">H", 4: ">I"}


# -- decoding -----------------------------------------------------------------
class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack data truncated at byte {self.pos} (need {n} more)")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, size: int) -> int:
        return struct.unpack(_UINT[size], self.take(size))[0]

    def obj(self, raw: bool = False) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.obj(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F, raw)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            fmt, n = _FIXED[b]
            return struct.unpack(fmt, self.take(n))[0]
        if b in _STR:
            return self.string(self.uint(_STR[b]), raw)
        if b in _BIN:
            return bytes(self.take(self.uint(_BIN[b])))
        if b in _ARRAY:
            return [self.obj(raw) for _ in range(self.uint(_ARRAY[b]))]
        if b in _MAP:
            return self.map(self.uint(_MAP[b]), raw)
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in _EXT:
            return self.ext(self.uint(_EXT[b]))
        raise ValueError(f"msgpack byte 0x{b:02x} at {self.pos - 1} is not a type flax writes")

    def string(self, n: int, raw: bool):
        data = self.take(n)
        return bytes(data) if raw else str(data, "utf-8")

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj(raw)
            out[k] = self.obj(raw)
        return out

    def ext(self, n: int) -> Any:
        code = struct.unpack(">b", self.take(1))[0]
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(data)[()]
        if code == _EXT_COMPLEX:
            re, im = _Reader(data).obj()
            return complex(re, im)
        raise ValueError(f"msgpack ext type {code} is not one of flax's (1 ndarray, 2 complex, 3 numpy scalar)")


def _ndarray_from_bytes(data) -> np.ndarray:
    """flax's ``_ndarray_from_bytes``: a packed (shape, dtype name, bytes)."""
    shape, name, buf = _Reader(data).obj(raw=True)
    name = name.decode("ascii")
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"array of dtype {name!r}, which numpy does not know") from e
    return np.frombuffer(buf, dtype).reshape(shape)


def _unchunk(d: dict) -> np.ndarray:
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d: Any) -> Any:
    """flax's ``_unchunk_array_leaves_in_place``: maps are walked, lists are not."""
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk(v) if _CHUNKED in v else _unchunk_leaves(v)
    return d


def unpackb(data: bytes) -> Any:
    """The tree of a flax msgpack file's bytes (``msgpack_restore``'s)."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes of extra data after the msgpack object")
    return _unchunk_leaves(out)


# -- encoding -----------------------------------------------------------------
def _header(n: int, fix: int, fix_max: int, wide: Tuple[Tuple[int, int, str], ...]) -> bytes:
    if n <= fix_max:
        return bytes([fix + n])
    for first, limit, fmt in wide:
        if n <= limit:
            return struct.pack(">B" + fmt, first, n)
    raise ValueError(f"msgpack object of {n} entries is too large")


def _int(x: int) -> bytes:
    if 0 <= x < 0x80 or -0x20 <= x < 0:
        return struct.pack(">b" if x < 0 else ">B", x)
    for lo, hi, first, fmt in ((0, 0xFF, 0xCC, "B"), (-0x80, -1, 0xD0, "b"), (0, 0xFFFF, 0xCD, "H"),
                               (-0x8000, -1, 0xD1, "h"), (0, 0xFFFFFFFF, 0xCE, "I"),
                               (-0x80000000, -1, 0xD2, "i"), (0, 2**64 - 1, 0xCF, "Q"), (-2**63, -1, 0xD3, "q")):
        if lo <= x <= hi:
            return struct.pack(">B" + fmt, first, x)
    raise OverflowError(f"int {x} does not fit in 64 bits")


def _bin(b: bytes) -> bytes:
    return _header(len(b), 0, -1, ((0xC4, 0xFF, "B"), (0xC5, 0xFFFF, "H"), (0xC6, 0xFFFFFFFF, "I"))) + b


def _ext(code: int, data: bytes) -> bytes:
    n = len(data)
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fix:
        head = bytes([fix[n]])
    else:
        head = _header(n, 0, -1, ((0xC7, 0xFF, "B"), (0xC8, 0xFFFF, "H"), (0xC9, 0xFFFFFFFF, "I")))
    return head + struct.pack(">b", code) + data


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be written")
    shape = [_int(d) for d in arr.shape]
    return (b"\x93" + _header(len(shape), 0x90, 0x0F, ((0xDC, 0xFFFF, "H"), (0xDD, 0xFFFFFFFF, "I")))
            + b"".join(shape) + _pack(arr.dtype.name) + _bin(arr.tobytes("C")))


def _pack_chunked(arr: np.ndarray) -> bytes:
    """flax's ``_chunk`` of an oversized array, its maps in flax's insertion order."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return (_map_header(3) + _pack(_CHUNKED) + b"\xc3"
            + _pack("shape") + _pack_map({str(i): d for i, d in enumerate(arr.shape)}, sort=False)
            + _pack("chunks") + _pack_map({str(i): c for i, c in enumerate(chunks)}, sort=False))


def _map_header(n: int) -> bytes:
    return _header(n, 0x80, 0x0F, ((0xDE, 0xFFFF, "H"), (0xDF, 0xFFFFFFFF, "I")))


def _pack_map(x: dict, sort: bool = True) -> bytes:
    """A map; ``msgpack_serialize`` copies the tree with ``jax.tree_util``,
    which orders every dict's keys, before it chunks."""
    keys = sorted(x) if sort else list(x)
    return _map_header(len(x)) + b"".join(_pack(k) + _pack_leaf(x[k]) for k in keys)


def _pack(x: Any) -> bytes:
    t = type(x)
    if x is None:
        return b"\xc0"
    if t is bool:
        return b"\xc3" if x else b"\xc2"
    if t is int:
        return _int(x)
    if t in (bytes, bytearray):
        return _bin(bytes(x))
    if t is str:
        b = x.encode("utf-8")
        return _header(len(b), 0xA0, 0x1F, ((0xD9, 0xFF, "B"), (0xDA, 0xFFFF, "H"), (0xDB, 0xFFFFFFFF, "I"))) + b
    if t is float:
        return struct.pack(">Bd", 0xCB, x)
    if t is list:
        head = _header(len(x), 0x90, 0x0F, ((0xDC, 0xFFFF, "H"), (0xDD, 0xFFFFFFFF, "I")))
        return head + b"".join(_pack(v) for v in x)
    if t is dict:
        return _pack_map(x)
    if isinstance(x, np.ndarray):
        return _ext(_EXT_NDARRAY, _ndarray_to_bytes(x))
    if isinstance(x, np.generic):
        return _ext(_EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(x)))
    if t is complex:
        return _ext(_EXT_COMPLEX, b"\x92" + struct.pack(">Bd", 0xCB, x.real) + struct.pack(">Bd", 0xCB, x.imag))
    raise TypeError(f"cannot write {t.__name__} to a flax msgpack file")


def _pack_leaf(x: Any) -> bytes:
    """A map's value or the top level, where flax chunks an oversized array."""
    return _pack_chunked(x) if type(x) is np.ndarray and x.size * x.dtype.itemsize > MAX_CHUNK_SIZE else _pack(x)


def packb(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``'s bytes."""
    return _pack_leaf(tree)
