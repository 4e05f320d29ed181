"""Row scatter-add (the hash table's gradient): wrapper, plain version and
kernel binding.

Port of ``xrnerf_tpu/ops/pallas/scatter_rows.py:scatter_add_rows``. The
kernel is the hand-written CUDA ``xrnerf_torch/csrc/scatter_rows.cu`` (f32
atomic additions in L2; its source note gives the design). The JAX package's
sorted-segment path and its mesh (``set_scatter_mesh``) are workarounds for
a slow scatter and a multi-chip matter; neither is here.

- :func:`scatter_add_rows` runs the plain version for CPU tensors and the
  kernel for CUDA tensors (raising on what the kernel does not take or a
  failed build or launch: there is no fallback). ``.launches`` counts kernel
  launches. On the card the order of the additions, and with it the last
  bits of a sum, changes from run to run.
- :func:`scatter_add_rows_plain` is the same function as one ``index_add_``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

_LIB: Optional[ctypes.CDLL] = None
_VP, _CI, _CLL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def scatter_add_rows_plain(idx: torch.Tensor, vals: torch.Tensor, num_rows: int, skip_zero_rows: bool = False) -> torch.Tensor:
    """Plain version of :func:`scatter_add_rows`: dropped rows go to an extra
    row that is cut off, so no shape depends on the data."""
    keep = idx >= 0
    if skip_zero_rows:
        keep = keep & (vals != 0).any(dim=-1)
    out = torch.zeros((num_rows + 1, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    out.index_add_(0, torch.where(keep, idx, num_rows).long(), vals)
    return out[:num_rows]


def _kernel_lib() -> ctypes.CDLL:
    """Build (first call) and bind ``csrc/scatter_rows.cu``."""
    global _LIB
    if _LIB is None:
        from .build import load_library

        lib = load_library("scatter_rows")
        for name in ("xr_scatter_add_rows_i32", "xr_scatter_add_rows_i64"):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = [_VP, _VP, _CLL, _CI, _CI, _VP, _VP], _CI
        lib.xr_scatter_add_rows_vectorised.argtypes, lib.xr_scatter_add_rows_vectorised.restype = [], _CI
        lib.xr_cuda_error_string.argtypes = [_CI]
        lib.xr_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def scatter_add_rows(idx: torch.Tensor, vals: torch.Tensor, num_rows: int, skip_zero_rows: bool = False) -> torch.Tensor:
    """``out[idx[i], :] += vals[i, :]`` over a fresh [num_rows, W] of zeros.

    idx: [N] int32 or int64 row ids in [0, num_rows), negative ids are
    dropped; vals: [N, W] float32. ``skip_zero_rows`` also drops the rows
    whose values are all zero (dead marched samples). The plain version on
    the CPU, the CUDA kernel on the card."""
    if idx.dim() != 1 or vals.dim() != 2 or idx.shape[0] != vals.shape[0]:
        raise ValueError(f"scatter_add_rows: expected idx [N] and vals [N, W], got {tuple(idx.shape)}, {tuple(vals.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"scatter_add_rows: idx must be int32 or int64, got {idx.dtype}")
    if idx.device != vals.device:
        raise ValueError(f"scatter_add_rows: idx is on {idx.device}, vals on {vals.device}")
    if vals.device.type == "cpu":
        return scatter_add_rows_plain(idx, vals, num_rows, skip_zero_rows)
    if vals.device.type != "cuda":
        raise ValueError(f"scatter_add_rows runs on cpu or cuda, not {vals.device}")
    if vals.dtype != torch.float32:
        raise TypeError(f"scatter_add_rows: the CUDA kernel adds float32 rows, got {vals.dtype}")
    if not (idx.is_contiguous() and vals.is_contiguous()):
        raise ValueError("scatter_add_rows: idx and vals must be contiguous")
    out = torch.zeros((num_rows, vals.shape[1]), dtype=torch.float32, device=vals.device)
    if idx.shape[0] == 0 or vals.shape[1] == 0 or num_rows == 0:
        return out
    lib = _kernel_lib()
    fn = lib.xr_scatter_add_rows_i32 if idx.dtype == torch.int32 else lib.xr_scatter_add_rows_i64
    with torch.cuda.device(vals.device):
        err = fn(idx.data_ptr(), vals.data_ptr(), idx.shape[0], vals.shape[1], int(skip_zero_rows),
                 out.data_ptr(), torch.cuda.current_stream(vals.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"scatter_add_rows launch failed: {lib.xr_cuda_error_string(err).decode()} ({err})")
    scatter_add_rows.launches += 1
    return out


scatter_add_rows.launches = 0
