"""Row scatter-add (the hash table's gradient): wrappers, plain versions and
kernel binding.

Port of ``xrnerf_tpu/ops/pallas/scatter_rows.py:scatter_add_rows``. The
kernel is the hand-written CUDA ``xrnerf_torch/csrc/scatter_rows.cu``: one
launch scatters a stack of levels, each level in the mode that
:func:`level_modes` picks (its source note gives the design). The JAX
package's sorted-segment path is a workaround for a slow scatter and is not
here. Its mesh route (``set_scatter_mesh``: a shard-local scatter per chip
and one ``psum`` of the partial tables) has two counterparts, with the same
kernel and no other:

- data axis: each rank scatters its own rows into a full local table (one
  launch, as on one card), and the trainer's gradient all-reduce over the
  data group is the sum of the partial tables;
- model axis: a rank that holds rows ``[offset, offset + T_m)`` of each
  level's table scatters ``idx - offset`` into a ``T_m``-row table with the
  level row counts :func:`shard_rows` gives; the kernel drops every id
  below 0 or at or past its level's count, so each rank adds exactly the
  rows of its slice.

- :func:`scatter_add_rows_levels` scatters ``[L, M]`` ids and ``[L, M, W]``
  rows into ``[L, T, W]`` in one launch: the encodings' backward. The plain
  version for CPU tensors, the kernel for CUDA tensors (raising on what the
  kernel does not take or a failed build or launch: there is no fallback).
- :func:`scatter_add_rows` is one level, the same kernel with L = 1.
- Each wrapper's ``.launches`` counts the launches it made. On the card the
  order of the additions, and with it the last bits of a sum, changes from
  run to run.
- :func:`scatter_add_rows_plain` / :func:`scatter_add_rows_levels_plain` are
  the same functions as one ``index_add_`` each.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

_LIB: Optional[ctypes.CDLL] = None
_VP, _CI, _CLL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

SHARED, AGGREGATE, PLAIN = 0, 1, 2
# A W = 2 level whose table (rows x 8 bytes) fits this many bytes is added in
# shared memory first. The launch's dynamic shared memory is the largest such
# table, and every CTA of the launch holds it, so the budget also caps how
# many CTAs of the other levels fit on an SM.
SHARED_TABLE_BYTES = 48 * 1024


def level_modes(rows_per_level: Sequence[int], width: int) -> list:
    """The mode of each level, the host's rule: for W = 2 rows SHARED where
    the table fits :data:`SHARED_TABLE_BYTES`, else AGGREGATE (both sum
    runs of equal ids within a warp first); PLAIN for other widths.

    The budget holds the coarsest vertex level (4,096 rows, 32 KB) and no
    other. Measured with ``tools/torch_ngp_kernel_probe.py`` on one real
    Instant-NGP step's 16 levels (NVIDIA H100 80GB HBM3, 700 W), whose ids
    arrive in march order, so that neighbouring samples share cells on
    every level: 0.2725 ms under this rule, 0.2751 with no shared table,
    0.2757 with the second level's 85 KB table shared too; on random
    points, where no run repeats, 0.4993, 0.5268 and 0.4944. Each level
    alone in march order takes 0.015-0.016 ms with its runs summed in the
    warp, the coarsest 0.045 in a shared table: the table pays only in a
    launch with other levels, or on random points."""
    if width != 2:
        return [PLAIN] * len(rows_per_level)
    return [SHARED if r * width * 4 <= SHARED_TABLE_BYTES else AGGREGATE for r in rows_per_level]


def shard_rows(rows_per_level: Sequence[int], offset: int, rows: int) -> list:
    """Each level's row count inside the slice ``[offset, offset + rows)`` of
    a table whose level l holds ``rows_per_level[l]`` rows."""
    return [min(max(int(r) - offset, 0), rows) for r in rows_per_level]


def scatter_add_rows_plain(idx: torch.Tensor, vals: torch.Tensor, num_rows: int, skip_zero_rows: bool = False) -> torch.Tensor:
    """Plain version of :func:`scatter_add_rows`: dropped rows (ids below 0
    or at or past ``num_rows``, as XLA's ``mode="drop"`` scatter drops them)
    go to an extra row that is cut off, so no shape depends on the data."""
    keep = (idx >= 0) & (idx < num_rows)
    if skip_zero_rows:
        keep = keep & (vals != 0).any(dim=-1)
    out = torch.zeros((num_rows + 1, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    out.index_add_(0, torch.where(keep, idx, num_rows).long(), vals)
    return out[:num_rows]


def scatter_add_rows_levels_plain(idx: torch.Tensor, vals: torch.Tensor, rows_per_level: Sequence[int], num_rows: int,
                                  skip_zero_rows: bool = False) -> torch.Tensor:
    """Plain version of :func:`scatter_add_rows_levels`: one ``index_add_``
    over ``idx + l * T``, dropped rows sent to a spare row."""
    L, M, W = vals.shape
    rows = torch.tensor(list(rows_per_level), dtype=torch.int64, device=idx.device)[:, None]
    keep = (idx >= 0) & (idx < rows)
    if skip_zero_rows:
        keep = keep & (vals != 0).any(dim=-1)
    offs = torch.arange(L, device=idx.device)[:, None] * num_rows
    flat = torch.where(keep, idx.long() + offs, L * num_rows)
    out = torch.zeros((L * num_rows + 1, W), dtype=vals.dtype, device=vals.device)
    out.index_add_(0, flat.reshape(-1), vals.reshape(L * M, W))
    return out[: L * num_rows].view(L, num_rows, W)


def _kernel_lib() -> ctypes.CDLL:
    """Build (first call) and bind ``csrc/scatter_rows.cu``."""
    global _LIB
    if _LIB is None:
        from .build import load_library

        lib = load_library("scatter_rows")
        for name in ("xr_scatter_add_rows_levels_i32", "xr_scatter_add_rows_levels_i64"):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = [_VP, _VP, _CI, _CLL, _CI, _CLL, _VP, _VP, _CI, _VP, _VP], _CI
        for name in ("xr_scatter_add_rows_vectorised", "xr_scatter_add_rows_max_levels",
                     "xr_scatter_add_rows_max_shared_bytes"):
            getattr(lib, name).argtypes, getattr(lib, name).restype = [], _CI
        lib.xr_cuda_error_string.argtypes = [_CI]
        lib.xr_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(name: str, idx: torch.Tensor, vals: torch.Tensor, lead: int) -> None:
    if idx.dim() != lead or vals.dim() != lead + 1 or idx.shape != vals.shape[:lead]:
        want = "idx [N] and vals [N, W]" if lead == 1 else "idx [L, M] and vals [L, M, W]"
        raise ValueError(f"{name}: expected {want}, got {tuple(idx.shape)}, {tuple(vals.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: idx must be int32 or int64, got {idx.dtype}")
    if idx.device != vals.device:
        raise ValueError(f"{name}: idx is on {idx.device}, vals on {vals.device}")
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {vals.device}")


def _launch(counted, idx: torch.Tensor, vals: torch.Tensor, rows: Sequence[int], num_rows: int, skip: bool,
            modes: Sequence[int]) -> torch.Tensor:
    """The kernel on [L, M] ids and [L, M, W] rows into a fresh [L, T, W],
    each level in its mode (:func:`level_modes`); one is added to the
    wrapper ``counted``'s ``.launches`` when the kernel was launched."""
    name = counted.__name__
    if vals.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel adds float32 rows, got {vals.dtype}")
    if not (idx.is_contiguous() and vals.is_contiguous()):
        raise ValueError(f"{name}: idx and vals must be contiguous")
    L, M, W = vals.shape
    if len(rows) != L or len(modes) != L or any(not 0 <= r <= num_rows for r in rows):
        raise ValueError(f"{name}: {L} levels need {L} row counts in [0, {num_rows}] and modes, got {list(rows)}, {list(modes)}")
    out = torch.zeros((L, num_rows, W), dtype=torch.float32, device=vals.device)
    if M == 0 or W == 0 or num_rows == 0 or L == 0:
        return out
    lib = _kernel_lib()
    if L > lib.xr_scatter_add_rows_max_levels():
        raise ValueError(f"{name}: at most {lib.xr_scatter_add_rows_max_levels()} levels a launch, got {L}")
    fn = lib.xr_scatter_add_rows_levels_i32 if idx.dtype == torch.int32 else lib.xr_scatter_add_rows_levels_i64
    c_rows, c_modes = (_CI * L)(*rows), (_CI * L)(*modes)
    with torch.cuda.device(vals.device):
        err = fn(idx.data_ptr(), vals.data_ptr(), L, M, W, num_rows, c_rows, c_modes, int(skip), out.data_ptr(),
                 torch.cuda.current_stream(vals.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.xr_cuda_error_string(err).decode()} ({err})")
    counted.launches += 1
    return out


def scatter_add_rows_levels(idx: torch.Tensor, vals: torch.Tensor, rows_per_level: Sequence[int], num_rows: int,
                            skip_zero_rows: bool = False) -> torch.Tensor:
    """``out[l, idx[l, i], :] += vals[l, i, :]`` over a fresh [L, T, W] of
    zeros, T = ``num_rows``, in one launch.

    idx: [L, M] int32 or int64; vals: [L, M, W] float32. Ids below 0 or at or
    past ``rows_per_level[l]`` are dropped, so those rows of level l stay
    zero. ``skip_zero_rows`` also drops the rows whose values are all zero
    (dead marched samples). The plain version on the CPU, the CUDA kernel on
    the card."""
    _check("scatter_add_rows_levels", idx, vals, 2)
    rows = [int(r) for r in rows_per_level]
    if vals.device.type == "cpu":
        return scatter_add_rows_levels_plain(idx, vals, rows, num_rows, skip_zero_rows)
    return _launch(scatter_add_rows_levels, idx, vals, rows, num_rows, skip_zero_rows, level_modes(rows, vals.shape[2]))


scatter_add_rows_levels.launches = 0


def scatter_add_rows(idx: torch.Tensor, vals: torch.Tensor, num_rows: int, skip_zero_rows: bool = False) -> torch.Tensor:
    """``out[idx[i], :] += vals[i, :]`` over a fresh [num_rows, W] of zeros.

    idx: [N] int32 or int64 row ids, those outside [0, num_rows) dropped;
    vals: [N, W] float32. ``skip_zero_rows`` also drops the rows whose values
    are all zero. The plain version on the CPU, the CUDA kernel (one level)
    on the card."""
    _check("scatter_add_rows", idx, vals, 1)
    if vals.device.type == "cpu":
        return scatter_add_rows_plain(idx, vals, num_rows, skip_zero_rows)
    return _launch(scatter_add_rows, idx[None], vals[None], [num_rows], num_rows, skip_zero_rows,
                   level_modes([num_rows], vals.shape[1]))[0]


scatter_add_rows.launches = 0
