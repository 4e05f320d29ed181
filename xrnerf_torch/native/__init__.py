"""Native (C++) host-side pieces of the port, bound with ctypes — a copy of
``xrnerf_tpu/native`` that builds into ``xrnerf_torch/_build/`` (listed in
``.gitignore``), never into the JAX package.

``load_mesh_grid()`` compiles ``mesh_grid.cpp`` with ``g++`` on first use
(the library is named by a hash of the source and flags, and reused while
they are unchanged) and raises if the compiler is missing or the build
fails: there is no silent fallback. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..ops.build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "mesh_grid.cpp"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib = None


def lib_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libmesh_grid-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; raises on failure."""
    out = lib_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("mesh_grid: no g++ on PATH to build the native mesh searcher")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SRC)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for mesh_grid.cpp (rc {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return out


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
