"""Vanilla NeRF's fused-path positional encoding in one launch: wrapper,
plain version and kernel binding.

The fused MLP (``ops/fused_nerf_mlp.py``) reads two float32 inputs a
sample: ``pts_enc`` = ``posenc_fast`` of the point (3 (1 + 2 L) columns) and
``views_enc`` = ``posenc_fast`` of its ray's view direction (3 (1 + 2 Ld)).
:func:`nerf_posenc` writes both from points [N, S, 3] and directions [N, 3]:
the plain version for a CPU tensor, the hand-written CUDA kernel
``xrnerf_torch/csrc/nerf_posenc.cu`` for a CUDA tensor (raising on what the
kernel does not take, or on a failed build or launch: there is no fallback).
``nerf_posenc.launches`` counts the kernel's launches.

It replaces no Pallas kernel: the JAX package encodes with ``posenc_fast``,
whose chain of elementwise operations XLA fuses. Run eagerly, the chain is
29 kernels a call, each reading and writing a whole [N S, L, 3] tensor, and
the view encoding is copied out to every sample (59 launches for the two
inputs). The kernel is bound by the bytes it writes (360 a row at L = 10,
Ld = 4, against 12 read): a CTA stages its rows' points and rays' directions
in shared memory, and its threads map onto the flat outputs, four
consecutive floats and one 16-byte store each, so a warp writes contiguous
bytes whatever the odd row width. Its arithmetic is ``posenc_fast``'s,
rounding for rounding, so its outputs are the plain version's bits on the
card. It has no backward: the points of NeRF's samples carry no gradient.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..models.embedders.posenc import posenc_channels, posenc_fast
from .fused_nerf_mlp import KERNEL_PV, KERNEL_PX

_LIB: Optional[ctypes.CDLL] = None
_VP, _CI, _CLL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def nerf_posenc_ref(pts: torch.Tensor, viewdirs: torch.Tensor, num_freqs: int,
                    num_freqs_dirs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`nerf_posenc`: ``posenc_fast`` of the points
    and of the directions, each direction's encoding expanded to its ray's S
    samples (expand + reshape: ``repeat_interleave`` would size its output
    with a device-to-host sync)."""
    n, s, _ = pts.shape
    pts_enc = posenc_fast(pts.reshape(n * s, 3), num_freqs)
    views_enc = posenc_fast(viewdirs, num_freqs_dirs)
    return pts_enc, views_enc[:, None].expand(n, s, views_enc.shape[-1]).reshape(n * s, -1)


def _kernel_lib() -> ctypes.CDLL:
    """Build (first call) and bind ``csrc/nerf_posenc.cu``."""
    global _LIB
    if _LIB is None:
        from .build import load_library

        lib = load_library("nerf_posenc")
        lib.xr_nerf_posenc.argtypes = [_VP, _VP, _CLL, _CI, _CI, _CI, _VP, _VP, _VP]
        lib.xr_nerf_posenc.restype = _CI
        lib.xr_cuda_error_string.argtypes = [_CI]
        lib.xr_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check_shapes(pts: torch.Tensor, viewdirs: torch.Tensor) -> None:
    if pts.dim() != 3 or pts.shape[2] != 3 or viewdirs.shape != (pts.shape[0], 3):
        raise ValueError(f"nerf_posenc: expected pts [N, S, 3] and viewdirs [N, 3], "
                         f"got {tuple(pts.shape)}, {tuple(viewdirs.shape)}")
    if viewdirs.device != pts.device:
        raise ValueError(f"nerf_posenc: pts are on {pts.device}, viewdirs on {viewdirs.device}")
    if pts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"nerf_posenc runs on cpu or cuda, not {pts.device}")


def _check_kernel_args(pts: torch.Tensor, viewdirs: torch.Tensor, num_freqs: int, num_freqs_dirs: int) -> None:
    """What the kernel takes: float32 inputs that need no gradient, and
    encodings no wider than the fused MLP kernel reads."""
    for name, t in (("pts", pts), ("viewdirs", viewdirs)):
        if t.dtype != torch.float32:
            raise TypeError(f"nerf_posenc: {name} must be float32, got {t.dtype}")
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError(f"nerf_posenc: {name} requires grad; the kernel has no backward")
    widths = (posenc_channels(3, num_freqs), posenc_channels(3, num_freqs_dirs))
    if num_freqs < 0 or num_freqs_dirs < 0 or widths[0] > KERNEL_PX or widths[1] > KERNEL_PV:
        raise ValueError(f"nerf_posenc: the fused MLP kernel reads at most {KERNEL_PX} / {KERNEL_PV} columns; "
                         f"{num_freqs} / {num_freqs_dirs} frequencies give {widths[0]} / {widths[1]}")


def nerf_posenc(pts: torch.Tensor, viewdirs: torch.Tensor, num_freqs: int,
                num_freqs_dirs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pts_enc [N S, 3 (1 + 2 L)], views_enc [N S, 3 (1 + 2 Ld)]) float32
    from points ``pts`` [N, S, 3] and per-ray directions ``viewdirs`` [N, 3]:
    row ``r`` encodes ``pts[r // S, r % S]`` and ``viewdirs[r // S]``. The
    plain version on the CPU, the CUDA kernel (one launch) on the card."""
    _check_shapes(pts, viewdirs)
    if pts.device.type == "cpu":
        return nerf_posenc_ref(pts, viewdirs, num_freqs, num_freqs_dirs)
    _check_kernel_args(pts, viewdirs, num_freqs, num_freqs_dirs)
    n, s, _ = pts.shape
    pts, viewdirs = pts.contiguous(), viewdirs.contiguous()
    f32 = dict(dtype=torch.float32, device=pts.device)
    pts_enc = torch.empty((n * s, posenc_channels(3, num_freqs)), **f32)
    views_enc = torch.empty((n * s, posenc_channels(3, num_freqs_dirs)), **f32)
    if n * s == 0:
        return pts_enc, views_enc
    lib = _kernel_lib()
    with torch.cuda.device(pts.device):
        err = lib.xr_nerf_posenc(pts.data_ptr(), viewdirs.data_ptr(), n * s, s, num_freqs, num_freqs_dirs,
                                 pts_enc.data_ptr(), views_enc.data_ptr(),
                                 torch.cuda.current_stream(pts.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nerf_posenc launch failed: {lib.xr_cuda_error_string(err).decode()} ({err})")
    nerf_posenc.launches += 1
    return pts_enc, views_enc


nerf_posenc.launches = 0
