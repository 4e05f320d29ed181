"""Native (C++) host-side pieces of the port, bound with ctypes — a copy of
``xrnerf_tpu/native`` that builds into ``xrnerf_torch/_build/`` (listed in
``.gitignore``), never into the JAX package, plus the image readers'
pieces: the PNG scanline unfilter (``png_unfilter.cpp``, for
``utils/png.py``) and the JPEG scan decoder (``jpeg_decode.cpp``, for
``utils/jpeg.py``).

``load_mesh_grid()``, ``load_png_unfilter()`` and ``load_jpeg_decoder()``
compile their source with ``g++`` on first use (a library is named by a
hash of its source and flags, and reused while they are unchanged) and
raise if the compiler is missing or the build fails: there is no silent
fallback. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..ops.build import BUILD_DIR

_DIR = Path(__file__).resolve().parent
SRC = _DIR / "mesh_grid.cpp"
PNG_SRC = _DIR / "png_unfilter.cpp"
JPEG_SRC = _DIR / "jpeg_decode.cpp"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib = None
_png_lib = None
_jpeg_lib = None


def _hashed_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def lib_path() -> Path:
    return _hashed_path(SRC)


def png_lib_path() -> Path:
    return _hashed_path(PNG_SRC)


def jpeg_lib_path() -> Path:
    return _hashed_path(JPEG_SRC)


def _compile(src: Path, out: Path) -> Path:
    """Compile ``src`` into ``out`` if it is not built yet; raises on failure."""
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"{src.stem}: no g++ on PATH to build {src.name}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(src)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {src.name} (rc {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def build() -> Path:
    """Compile the mesh-grid library if it is not built yet; raises on failure."""
    return _compile(SRC, lib_path())


def _load_reader(src: Path, path: Path, what: str) -> ctypes.CDLL:
    """An image reader's library, built on first use; raises naming g++ and the build directory."""
    try:
        return ctypes.CDLL(str(_compile(src, path)))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"reading a {what} builds {src.name} on first use: it needs g++ on PATH and a "
                           f"writable {BUILD_DIR}, and the build failed: {e}") from e


def load_png_unfilter() -> ctypes.CDLL:
    """ctypes handle to the PNG unfilter library (built on first use)."""
    global _png_lib
    if _png_lib is None:
        lib = _load_reader(PNG_SRC, png_lib_path(), "PNG")
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.png_unfilter.restype = ctypes.c_int64
        lib.png_unfilter.argtypes = [u8p, u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        _png_lib = lib
    return _png_lib


def load_jpeg_decoder() -> ctypes.CDLL:
    """ctypes handle to the JPEG scan decoder (built on first use)."""
    global _jpeg_lib
    if _jpeg_lib is None:
        lib = _load_reader(JPEG_SRC, jpeg_lib_path(), "JPEG")
        u8p, i16p, i32p = (ctypes.POINTER(t) for t in (ctypes.c_uint8, ctypes.c_int16, ctypes.c_int32))
        lib.jpeg_decode_scan.restype = ctypes.c_int64
        lib.jpeg_decode_scan.argtypes = [u8p, ctypes.c_int64, i32p, i32p, ctypes.c_int32, u8p, ctypes.c_int32, i16p]
        lib.jpeg_pixels.restype = None
        lib.jpeg_pixels.argtypes = [i32p, i16p, i32p, ctypes.c_int32, u8p]
        _jpeg_lib = lib
    return _jpeg_lib


def load_mesh_grid() -> ctypes.CDLL:
    """ctypes handle to the mesh-grid library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.mg_create.restype = ctypes.c_void_p
        lib.mg_create.argtypes = [f32p, ctypes.c_int, i32p, ctypes.c_int, ctypes.c_int]
        lib.mg_destroy.argtypes = [ctypes.c_void_p]
        lib.mg_nearest.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int, f32p, i32p, f32p]
        lib.mg_inside.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int, f32p]
        lib.mg_intersect.argtypes = [ctypes.c_void_p, f32p, f32p, ctypes.c_int, f32p, u8p]
        _lib = lib
    return _lib
