"""Fused tiny MLPs (Instant-NGP's density and colour nets), forward:
wrappers, plain versions and kernel bindings.

Port of ``xrnerf_tpu/ops/pallas/fused_mlp.py``'s two forward kernels
(``_fwd2_kernel``, ``_fwd3_kernel``). The kernels are the hand-written CUDA
``xrnerf_torch/csrc/fused_mlp_fwd.cu``; its source note gives the design.
Arguments are the JAX functions': f32 ``x`` [N, d_in], f32 weights stored
[in, out] and f32 biases. Numerics are the TPU bodies': x and weights
rounded to bf16, f32 accumulation, f32 biases, each hidden activation
rounded to bf16 after its ReLU, f32 output.

- :func:`fused_mlp2` / :func:`fused_mlp3` run the plain version for CPU
  tensors and the kernel for CUDA tensors (raising on a shape the kernel
  does not take or a failed build or launch: there is no fallback).
  ``.launches`` on each counts kernel launches.
- :func:`fused_mlp2_plain` / :func:`fused_mlp3_plain` are the same functions
  in torch ops, rounded at the same points; autograd differentiates them.
- The backward kernels (``_bwd2_kernel``, ``_bwd3_kernel``) are not ported
  yet, so asking the card for a gradient through these ops raises
  ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

_BF = torch.bfloat16
_LIB: Optional[ctypes.CDLL] = None
_VP, _CI, _CLL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _rb(a: torch.Tensor) -> torch.Tensor:
    """Round to bf16, compute on in f32."""
    return a.to(_BF).float()


def fused_mlp2_plain(x, w1, b1, w2, b2) -> torch.Tensor:
    """Plain version of :func:`fused_mlp2`: ``relu(x@w1+b1)@w2+b2``, [N, d_out] f32."""
    h = F.relu(_rb(x) @ _rb(w1) + b1.float())
    return _rb(h) @ _rb(w2) + b2.float()


def fused_mlp3_plain(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Plain version of :func:`fused_mlp3`: two hidden ReLU layers + linear out."""
    h1 = F.relu(_rb(x) @ _rb(w1) + b1.float())
    h2 = F.relu(_rb(h1) @ _rb(w2) + b2.float())
    return _rb(h2) @ _rb(w3) + b3.float()


def _kernel_lib() -> ctypes.CDLL:
    """Build (first call) and bind ``csrc/fused_mlp_fwd.cu``."""
    global _LIB
    if _LIB is None:
        from .build import load_library

        lib = load_library("fused_mlp_fwd")
        lib.xr_fused_mlp2_fwd.argtypes = [_VP, _CI, _CLL, _VP, _VP, _CI, _VP, _VP, _CI, _VP, _VP]
        lib.xr_fused_mlp3_fwd.argtypes = [_VP, _CI, _CLL, _VP, _VP, _CI, _VP, _VP, _CI, _VP, _VP, _CI, _VP, _VP]
        lib.xr_fused_mlp2_fwd.restype = lib.xr_fused_mlp3_fwd.restype = _CI
        for what in ("din", "hidden", "dout"):
            f = getattr(lib, f"xr_fused_mlp_fwd_max_{what}")
            f.argtypes, f.restype = [], _CI
        lib.xr_cuda_error_string.argtypes = [_CI]
        lib.xr_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(name: str, x: torch.Tensor, layers) -> str:
    """Validate ``x`` [N, d_in] against the (weight [in, out], bias [out])
    chain, and refuse a gradient on the card; returns the device type."""
    if x.dim() != 2:
        raise ValueError(f"{name}: expected x [N, d_in], got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    width = x.shape[1]
    for i, (w, b) in enumerate(layers, 1):
        if w.dim() != 2 or w.shape[0] != width or b.shape != (w.shape[1],):
            raise ValueError(
                f"{name}: layer {i} takes {width} inputs, got weight {tuple(w.shape)} and bias {tuple(b.shape)}"
            )
        width = w.shape[1]
    if x.device.type == "cuda" and torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *(t for wb in layers for t in wb))
    ):
        raise NotImplementedError(
            f"{name}: the backward kernels of the fused tiny MLPs (_bwd2_kernel, _bwd3_kernel) are "
            "not ported yet; they come with the Instant-NGP training slice (slice 4). "
            "Run the card path under torch.no_grad() / inference_mode()."
        )
    return x.device.type


def _check_kernel_args(name: str, lib, x: torch.Tensor, layers) -> None:
    tensors = [("x", x)] + [(f"{k}{i}", t) for i, wb in enumerate(layers, 1) for k, t in zip("wb", wb)]
    for tname, t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name}: {tname} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {tname} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    din, hidden, dout = (getattr(lib, f"xr_fused_mlp_fwd_max_{k}")() for k in ("din", "hidden", "dout"))
    widths = [w.shape[1] for w, _ in layers]
    if x.shape[1] > din or max(widths[:-1]) > hidden or widths[-1] > dout:
        raise ValueError(
            f"{name}: the CUDA kernel takes d_in <= {din}, hidden <= {hidden} and d_out <= {dout}; "
            f"got d_in {x.shape[1]} and layer widths {widths}"
        )


def _launch(name: str, fn, lib, x: torch.Tensor, layers) -> torch.Tensor:
    n, dout = x.shape[0], layers[-1][0].shape[1]
    out = torch.empty((n, dout), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    args = [x.data_ptr(), x.shape[1], n]
    for w, b in layers:
        args += [w.data_ptr(), b.data_ptr(), w.shape[1]]
    with torch.cuda.device(x.device):
        err = fn(*args, out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.xr_cuda_error_string(err).decode()} ({err})")
    return out


def fused_mlp2(x, w1, b1, w2, b2) -> torch.Tensor:
    """``relu(x@w1+b1)@w2+b2`` as one fused kernel: x [N, d_in] f32, weights
    [in, out] f32 (bf16 compute), returns [N, d_out] f32. The plain version
    on the CPU, the CUDA kernel on the card."""
    layers = [(w1, b1), (w2, b2)]
    if _check("fused_mlp2", x, layers) == "cpu":
        return fused_mlp2_plain(x, w1, b1, w2, b2)
    lib = _kernel_lib()
    _check_kernel_args("fused_mlp2", lib, x, layers)
    out = _launch("fused_mlp2", lib.xr_fused_mlp2_fwd, lib, x, layers)
    if x.shape[0]:
        fused_mlp2.launches += 1
    return out


fused_mlp2.launches = 0


def fused_mlp3(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Two hidden ReLU layers + linear out, fused; returns [N, d_out] f32.
    The plain version on the CPU, the CUDA kernel on the card."""
    layers = [(w1, b1), (w2, b2), (w3, b3)]
    if _check("fused_mlp3", x, layers) == "cpu":
        return fused_mlp3_plain(x, w1, b1, w2, b2, w3, b3)
    lib = _kernel_lib()
    _check_kernel_args("fused_mlp3", lib, x, layers)
    out = _launch("fused_mlp3", lib.xr_fused_mlp3_fwd, lib, x, layers)
    if x.shape[0]:
        fused_mlp3.launches += 1
    return out


fused_mlp3.launches = 0
