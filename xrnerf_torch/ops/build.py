"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``xrnerf_torch/csrc/<name>.cu`` has a plain C interface and includes
no PyTorch header, so it compiles in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

The library is named by a hash of its source (and the shared headers and
flags), built on first use into ``xrnerf_torch/_build/`` (listed in
``.gitignore``) and reused while the source is unchanged. nvcc's output
(``-Xptxas=-v``: registers and spills) is kept beside it as ``.log``.
Nothing is built at import time; the CPU path never builds.
:func:`load_libraries` builds several sources at once, one ``nvcc`` each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers / spills per kernel, kept in the build log
]

_LIBS: Dict[str, ctypes.CDLL] = {}


def lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as a ctypes library."""
    if name in _LIBS:
        return _LIBS[name]
    out = lib_path(name)
    if not out.exists():
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        out.with_suffix(".log").write_text(proc.stdout)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, out)
    _LIBS[name] = ctypes.CDLL(str(out))
    return _LIBS[name]


def load_libraries(names: Sequence[str]) -> List[ctypes.CDLL]:
    """:func:`load_library` for each name, the ``nvcc`` calls all started together."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        return list(ex.map(load_library, names))
