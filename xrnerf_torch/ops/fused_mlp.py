"""Fused tiny MLPs (Instant-NGP's density and colour nets), forward and
backward: wrappers, plain versions, kernel bindings and the autograd ops.

Port of ``xrnerf_tpu/ops/pallas/fused_mlp.py`` (``_fwd2_kernel``,
``_bwd2_kernel``, ``_fwd3_kernel``, ``_bwd3_kernel``). The kernels are the
hand-written CUDA ``xrnerf_torch/csrc/fused_mlp_fwd.cu`` and
``fused_mlp_bwd.cu``; their source notes give the designs. Arguments are
the JAX functions': f32 ``x`` [N, d_in], f32 weights stored [in, out] and
f32 biases. Numerics are the TPU bodies': x and weights rounded to bf16,
f32 accumulation, f32 biases, each hidden activation rounded to bf16 after
its ReLU, f32 output; the backward recomputes the pre-activations, rounds
the upstream gradient and each dpre to bf16 before its products, takes the
ReLU mask from the f32 pre-activation and sums bias gradients from the f32
dpre.

- :func:`fused_mlp2` / :func:`fused_mlp3` run the plain version for CPU
  tensors (autograd differentiates it) and the kernels for CUDA tensors,
  through :class:`FusedMLP2Function` / :class:`FusedMLP3Function`, whose
  backward runs only where a gradient is wanted. They raise on a shape the kernels do not take or a
  failed build or launch: there is no fallback. ``.launches`` counts the
  forward kernel's launches.
- :func:`fused_mlp2_bwd` / :func:`fused_mlp3_bwd` are the backward wrappers:
  (dx, dw1, db1, ...) from (x, weights, g), the plain version on the CPU,
  the kernel on the card; ``.launches`` counts the backward kernel's.
- :func:`fused_mlp2_plain` / :func:`fused_mlp3_plain` and
  :func:`fused_mlp2_bwd_plain` / :func:`fused_mlp3_bwd_plain` are the same
  functions in torch ops, rounded at the same points.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

_BF = torch.bfloat16
_LIBS: Dict[str, ctypes.CDLL] = {}
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


def _bwd_plain(x, layers, g) -> Tuple[torch.Tensor, ...]:
    """The Pallas backward bodies (``_bwd2_kernel`` :77-108, ``_bwd3_kernel``
    :202-241) step by step for a chain of (weight [in, out], bias) layers:
    (dx, dw1, db1, dw2, db2, ...), all f32."""
    ws = [_rb(w) for w, _ in layers]
    acts, pres = [_rb(x)], []  # bf16-valued layer inputs; f32 pre-activations
    for w, (_, b) in zip(ws[:-1], layers[:-1]):
        pres.append(acts[-1] @ w + b.float())
        acts.append(_rb(F.relu(pres[-1])))
    g = g.float()
    d, db = _rb(g), g.sum(0)  # the last layer: bf16 g in the products, f32 g in the bias sum
    grads: List[torch.Tensor] = []
    for i in range(len(layers) - 1, -1, -1):
        grads[:0] = [acts[i].t() @ d, db]
        dh = d @ ws[i].t()
        if i == 0:
            return (dh, *grads)
        dpre = torch.where(pres[i - 1] > 0, dh, torch.zeros_like(dh))
        d, db = _rb(dpre), dpre.sum(0)


def fused_mlp2_bwd_plain(x, w1, b1, w2, g) -> Tuple[torch.Tensor, ...]:
    """Plain version of :func:`fused_mlp2_bwd`: (dx, dw1, db1, dw2, db2)."""
    return _bwd_plain(x, [(w1, b1), (w2, None)], g)


def fused_mlp3_bwd_plain(x, w1, b1, w2, b2, w3, g) -> Tuple[torch.Tensor, ...]:
    """Plain version of :func:`fused_mlp3_bwd`: (dx, dw1, db1, dw2, db2, dw3, db3)."""
    return _bwd_plain(x, [(w1, b1), (w2, b2), (w3, None)], g)


_FWD2 = [_VP, _CI, _CLL, _VP, _VP, _CI, _VP, _VP, _CI, _VP, _VP]
_FWD3 = [_VP, _CI, _CLL, _VP, _VP, _CI, _VP, _VP, _CI, _VP, _VP, _CI, _VP, _VP]
_BWD2 = [_VP, _CI, _CLL, _VP, _VP, _CI, _VP, _CI, _VP, _VP, _VP, _VP, _CI, _VP]
_BWD3 = [_VP, _CI, _CLL, _VP, _VP, _CI, _VP, _VP, _CI, _VP, _CI, _VP, _VP, _VP, _VP, _CI, _VP]


def _kernel_lib(which: str = "fwd") -> ctypes.CDLL:
    """Build (first call) and bind ``csrc/fused_mlp_<which>.cu``."""
    if which not in _LIBS:
        from .build import load_library

        lib = load_library(f"fused_mlp_{which}")
        for name, argtypes in ((f"xr_fused_mlp2_{which}", _FWD2 if which == "fwd" else _BWD2),
                               (f"xr_fused_mlp3_{which}", _FWD3 if which == "fwd" else _BWD3)):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, _CI
        extra = [f"xr_fused_mlp_{which}_max_{what}" for what in ("din", "hidden", "dout")]
        if which == "bwd":
            extra += ["xr_fused_mlp_bwd_max_parts", "xr_fused_mlp2_bwd_smem_bytes", "xr_fused_mlp3_bwd_smem_bytes"]
        for name in extra:
            getattr(lib, name).argtypes, getattr(lib, name).restype = [], _CI
        lib.xr_cuda_error_string.argtypes = [_CI]
        lib.xr_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[which] = lib
    return _LIBS[which]


def _check(name: str, x: torch.Tensor, layers) -> str:
    """Validate ``x`` [N, d_in] against the (weight [in, out], bias [out])
    chain (a ``None`` bias is not checked); returns the device type."""
    if x.dim() != 2:
        raise ValueError(f"{name}: expected x [N, d_in], got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    width = x.shape[1]
    for i, (w, b) in enumerate(layers, 1):
        if w.dim() != 2 or w.shape[0] != width or (b is not None and b.shape != (w.shape[1],)):
            raise ValueError(
                f"{name}: layer {i} takes {width} inputs, got weight {tuple(w.shape)}"
                + (f" and bias {tuple(b.shape)}" if b is not None else "")
            )
        width = w.shape[1]
    return x.device.type


def _check_kernel_args(name: str, lib, which: str, x: torch.Tensor, layers, g=None) -> None:
    tensors = [("x", x)] + [(f"{k}{i}", t) for i, wb in enumerate(layers, 1) for k, t in zip("wb", wb)]
    for tname, t in tensors + [("g", g)]:
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name}: {tname} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {tname} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    din, hidden, dout = (getattr(lib, f"xr_fused_mlp_{which}_max_{k}")() for k in ("din", "hidden", "dout"))
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
    return FusedMLP2Function.apply(x, w1, b1, w2, b2)


def _fused_mlp2_cuda(x, w1, b1, w2, b2) -> torch.Tensor:
    layers = [(w1, b1), (w2, b2)]
    lib = _kernel_lib()
    _check_kernel_args("fused_mlp2", lib, "fwd", x, layers)
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
    return FusedMLP3Function.apply(x, w1, b1, w2, b2, w3, b3)


def _fused_mlp3_cuda(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    layers = [(w1, b1), (w2, b2), (w3, b3)]
    lib = _kernel_lib()
    _check_kernel_args("fused_mlp3", lib, "fwd", x, layers)
    out = _launch("fused_mlp3", lib.xr_fused_mlp3_fwd, lib, x, layers)
    if x.shape[0]:
        fused_mlp3.launches += 1
    return out


fused_mlp3.launches = 0


def _launch_bwd(name: str, x: torch.Tensor, layers, g: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The backward kernel for a chain of (weight, bias) layers (the last
    bias ``None``): dx and the flat gradient buffer cut into (dw, db) views."""
    lib = _kernel_lib("bwd")
    _check_kernel_args(name, lib, "bwd", x, layers, g)
    for tname, t in (("x", x), ("g", g)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the CUDA kernel copies {tname} in 16-byte blocks; {tname} is not 16-byte aligned")
    n = x.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    sizes = [s for w, _ in layers for s in (w.numel(), w.shape[1])]
    dx = torch.empty(x.shape, **f32)
    if n == 0:
        grads = torch.zeros(sum(sizes), **f32)
    else:
        grads = torch.empty(sum(sizes), **f32)
        with torch.cuda.device(x.device):
            max_parts = lib.xr_fused_mlp_bwd_max_parts()
            if max_parts < 1:
                raise RuntimeError(f"{name}: the CUDA device reports no multiprocessors")
            part = torch.empty((max_parts, grads.numel()), **f32)  # one partial per CTA
            args = [x.data_ptr(), x.shape[1], n]
            for w, b in layers:
                args += [w.data_ptr()] + ([b.data_ptr()] if b is not None else []) + [w.shape[1]]
            fn = lib.xr_fused_mlp2_bwd if len(layers) == 2 else lib.xr_fused_mlp3_bwd
            err = fn(*args, g.data_ptr(), dx.data_ptr(), grads.data_ptr(), part.data_ptr(), max_parts,
                     torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: {lib.xr_cuda_error_string(err).decode()} ({err})")
    pieces = grads.split(sizes)
    out = [t for (w, _), dw, db in zip(layers, pieces[0::2], pieces[1::2]) for t in (dw.view(w.shape), db)]
    return (dx, *out)


def _check_bwd(name: str, x, layers, g) -> str:
    dev = _check(name, x, layers)
    if g.shape != (x.shape[0], layers[-1][0].shape[1]):
        raise ValueError(f"{name}: expected g {(x.shape[0], layers[-1][0].shape[1])}, got {tuple(g.shape)}")
    return dev


def fused_mlp2_bwd(x, w1, b1, w2, g) -> Tuple[torch.Tensor, ...]:
    """Backward of :func:`fused_mlp2` for the upstream gradient ``g``
    [N, d_out]: (dx, dw1, db1, dw2, db2) in f32. The plain version on the
    CPU, the CUDA kernel on the card."""
    layers = [(w1, b1), (w2, None)]
    if _check_bwd("fused_mlp2_bwd", x, layers, g) == "cpu":
        return fused_mlp2_bwd_plain(x, w1, b1, w2, g)
    out = _launch_bwd("fused_mlp2_bwd", x, layers, g)
    if x.shape[0]:
        fused_mlp2_bwd.launches += 1
    return out


fused_mlp2_bwd.launches = 0


def fused_mlp3_bwd(x, w1, b1, w2, b2, w3, g) -> Tuple[torch.Tensor, ...]:
    """Backward of :func:`fused_mlp3`: (dx, dw1, db1, dw2, db2, dw3, db3) in
    f32. The plain version on the CPU, the CUDA kernel on the card."""
    layers = [(w1, b1), (w2, b2), (w3, None)]
    if _check_bwd("fused_mlp3_bwd", x, layers, g) == "cpu":
        return fused_mlp3_bwd_plain(x, w1, b1, w2, b2, w3, g)
    out = _launch_bwd("fused_mlp3_bwd", x, layers, g)
    if x.shape[0]:
        fused_mlp3_bwd.launches += 1
    return out


fused_mlp3_bwd.launches = 0


class FusedMLP2Function(torch.autograd.Function):
    """:func:`fused_mlp2` as an autograd op (the custom VJP of the JAX
    function, ``_fused2_fwd`` / ``_fused2_bwd``): the forward saves its
    inputs, the backward recomputes the hidden layer inside
    :func:`fused_mlp2_bwd`."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2)
        return _fused_mlp2_cuda(x, w1, b1, w2, b2) if x.is_cuda else fused_mlp2_plain(x, w1, b1, w2, b2)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        grads = fused_mlp2_bwd(*ctx.saved_tensors, g.contiguous())
        return tuple(t if need else None for t, need in zip(grads, ctx.needs_input_grad))


class FusedMLP3Function(torch.autograd.Function):
    """:func:`fused_mlp3` as an autograd op; see :class:`FusedMLP2Function`."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w3, b3):
        ctx.save_for_backward(x, w1, b1, w2, b2, w3)
        if x.is_cuda:
            return _fused_mlp3_cuda(x, w1, b1, w2, b2, w3, b3)
        return fused_mlp3_plain(x, w1, b1, w2, b2, w3, b3)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        grads = fused_mlp3_bwd(*ctx.saved_tensors, g.contiguous())
        return tuple(t if need else None for t, need in zip(grads, ctx.needs_input_grad))
