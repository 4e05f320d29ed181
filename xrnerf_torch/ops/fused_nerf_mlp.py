"""Fused vanilla-NeRF MLP forward: wrapper, plain version and kernel binding.

Port of ``xrnerf_tpu/ops/pallas/fused_nerf_mlp.py`` (forward only; the
backward kernel comes with training). The kernel is the hand-written CUDA
``xrnerf_torch/csrc/fused_nerf_mlp_fwd.cu``; its source note gives the
design. Numerics are the TPU kernel's ``_trunk_forward``: bf16 operands,
f32 accumulation and biases, hidden activations rounded to bf16, sigma
from the f32 accumulator, rgb in f32.

- :func:`pack_params` packs an ``NerfMLP``'s weights once into one bf16
  and one f32 buffer. It holds the operands of the TPU pack
  (``_packed_shapes``, :281-295), stored [out, in] so each mma B-fragment
  register is one 32-bit load, with the 384-wide ``feature|alpha`` head
  split into a 256-row feature block and an 8-row alpha block, and the
  rgb head padded to 8 rows rather than 128.
- :func:`fused_nerf_mlp_fwd` runs it: the plain version for a CPU tensor,
  the kernel for a CUDA tensor (raising if the kernel cannot build or
  launch — there is no fallback). ``fused_nerf_mlp_fwd.launches`` counts
  kernel launches.
- :func:`fused_nerf_mlp_ref` is the plain version: the same function in
  torch ops, rounded at the same points, with bf16 operands emulated as
  f32 values (``a.to(bf16).float() @ w.to(bf16).float()``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Mapping, NamedTuple, Tuple

import torch
import torch.nn.functional as F

_BF = torch.bfloat16
_HEAD = 8  # alpha / rgb heads padded to one mma n-tile
KERNEL_WIDTH = 256  # the width the CUDA kernel is compiled for
KERNEL_PX, KERNEL_PV = 64, 32  # padded posenc widths (63 -> 64, 27 -> 32)


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


class PackedNerfMLP(NamedTuple):
    weights: torch.Tensor  # bf16, flat, matrices [out, in] in _layout order
    biases: torch.Tensor  # f32, flat
    width: int
    din: int  # pts_enc width
    dv: int  # views_enc width
    px: int  # padded pts_enc width
    pv: int  # padded views_enc width


def _layout(width: int, px: int, pv: int) -> Tuple[List[Tuple[str, int, int]], List[Tuple[str, int]]]:
    """(name, rows, cols) of each packed matrix and (name, len) of each bias,
    in buffer order. Must match the offsets in ``fused_nerf_mlp_fwd.cu``."""
    hv = width // 2
    mats = [("w0", width, px)]
    mats += [(f"w{i}", width, width) for i in range(1, 5)]
    mats += [("w5h", width, width), ("w5x", width, px), ("w6", width, width), ("w7", width, width)]
    mats += [("wf", width, width), ("wa", _HEAD, width), ("wvf", hv, width), ("wvv", hv, pv)]
    mats += [("wrgb", _HEAD, hv)]
    biases = [(f"b{i}", width) for i in range(8)]
    biases += [("bf", width), ("ba", _HEAD), ("bv", hv), ("brgb", _HEAD)]
    return mats, biases


def pack_params(sd: Mapping[str, torch.Tensor], din: int, dv: int) -> PackedNerfMLP:
    """Pack a ``NerfMLP`` state dict (``pts_0.weight`` [out, in], ...) for
    ``pts_enc`` of width ``din`` and ``views_enc`` of width ``dv``."""

    def w(name):
        return sd[f"{name}.weight"]

    def b(name):
        return sd[f"{name}.bias"]

    def pad_cols(m, cols):
        return F.pad(m, (0, cols - m.shape[1]))

    def pad_rows(m, rows):
        return F.pad(m, (0, 0, 0, rows - m.shape[0]))

    width = w("pts_0").shape[0]
    px, pv = _ceil_to(din, 64), _ceil_to(dv, 32)
    w5 = w("pts_5")  # [width, din + width]; the skip input is cat([x, h])
    wv = w("views_0")  # [width/2, width + dv]; input is cat([feat, views])
    mats = [
        pad_cols(w("pts_0"), px),
        *(w(f"pts_{i}") for i in range(1, 5)),
        w5[:, din:], pad_cols(w5[:, :din], px),
        w("pts_6"), w("pts_7"),
        w("feature"), pad_rows(w("alpha"), _HEAD),
        wv[:, :width], pad_cols(wv[:, width:], pv),
        pad_rows(w("rgb"), _HEAD),
    ]
    biases = [
        *(b(f"pts_{i}") for i in range(8)),
        b("feature"), F.pad(b("alpha"), (0, _HEAD - 1)),
        b("views_0"), F.pad(b("rgb"), (0, _HEAD - 3)),
    ]
    shapes, lens = _layout(width, px, pv)
    if [tuple(m.shape) for m in mats] != [(r, c) for _, r, c in shapes] or [
        t.shape[0] for t in biases
    ] != [n for _, n in lens]:
        raise ValueError(
            f"state dict does not hold a NerfMLP of width {width} with inputs {din}/{dv}"
        )
    wbuf = torch.cat([m.reshape(-1) for m in mats]).to(_BF).contiguous()
    bbuf = torch.cat([t.reshape(-1) for t in biases]).float().contiguous()
    return PackedNerfMLP(wbuf, bbuf, width, din, dv, px, pv)


def unpack_params(packed: PackedNerfMLP) -> Dict[str, torch.Tensor]:
    """Named views into the pack: matrices [out, in] (bf16), biases (f32)."""
    shapes, lens = _layout(packed.width, packed.px, packed.pv)
    out, o = {}, 0
    for name, r, c in shapes:
        out[name] = packed.weights[o : o + r * c].view(r, c)
        o += r * c
    o = 0
    for name, n in lens:
        out[name] = packed.biases[o : o + n]
        o += n
    return out


def fused_nerf_mlp_ref(
    x: torch.Tensor, v: torch.Tensor, packed: PackedNerfMLP
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (raw_rgb [N, 3], raw_sigma [N]) in f32."""
    p = unpack_params(packed)

    def rb(a):  # round to bf16, compute on in f32
        return a.to(_BF).float()

    def mm(a, name):  # bf16-valued operands, f32 accumulation
        return a @ p[name].float().t()

    xb = rb(F.pad(x.float(), (0, packed.px - x.shape[1])))
    vb = rb(F.pad(v.float(), (0, packed.pv - v.shape[1])))
    h = rb(F.relu(mm(xb, "w0") + p["b0"]))
    for i in range(1, 5):
        h = rb(F.relu(mm(h, f"w{i}") + p[f"b{i}"]))
    h = rb(F.relu(mm(h, "w5h") + mm(xb, "w5x") + p["b5"]))
    for i in (6, 7):
        h = rb(F.relu(mm(h, f"w{i}") + p[f"b{i}"]))
    feat = rb(mm(h, "wf") + p["bf"])
    sigma = (mm(h, "wa") + p["ba"])[:, 0]
    v1 = rb(F.relu(mm(feat, "wvf") + mm(vb, "wvv") + p["bv"]))
    rgb = (mm(v1, "wrgb") + p["brgb"])[:, :3]
    return rgb.contiguous(), sigma.contiguous()


_LIB = None


def _kernel_lib():
    global _LIB
    if _LIB is None:
        from .build import load_library

        lib = load_library("fused_nerf_mlp_fwd")
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.xr_fused_nerf_mlp_fwd.argtypes = [vp, ci, vp, ci, cll, vp, vp, vp, vp, vp]
        lib.xr_fused_nerf_mlp_fwd.restype = ci
        lib.xr_fused_nerf_mlp_fwd_weight_elems.argtypes = []
        lib.xr_fused_nerf_mlp_fwd_weight_elems.restype = cll
        lib.xr_fused_nerf_mlp_fwd_bias_elems.argtypes = []
        lib.xr_fused_nerf_mlp_fwd_bias_elems.restype = cll
        lib.xr_cuda_error_string.argtypes = [ci]
        lib.xr_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check_kernel_args(x, v, packed: PackedNerfMLP) -> None:
    if (packed.width, packed.px, packed.pv) != (KERNEL_WIDTH, KERNEL_PX, KERNEL_PV):
        raise ValueError(
            f"the CUDA kernel is built for width {KERNEL_WIDTH}, pts_enc <= {KERNEL_PX} "
            f"and views_enc <= {KERNEL_PV} columns; got width {packed.width}, "
            f"padded inputs {packed.px}/{packed.pv}"
        )
    for name, t, dt in (("pts_enc", x, torch.float32), ("views_enc", v, torch.float32),
                        ("weights", packed.weights, _BF), ("biases", packed.biases, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, pts_enc on {x.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_nerf_mlp_fwd(
    x: torch.Tensor, v: torch.Tensor, packed: PackedNerfMLP
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(raw_rgb [N, 3], raw_sigma [N]) f32 from pts_enc ``x`` [N, dx] and
    views_enc ``v`` [N, dv]: the plain version on the CPU, the CUDA kernel
    on the card."""
    if x.dim() != 2 or v.dim() != 2 or x.shape[0] != v.shape[0]:
        raise ValueError(f"expected pts_enc [N, dx] and views_enc [N, dv], got {tuple(x.shape)}, {tuple(v.shape)}")
    if (x.shape[1], v.shape[1]) != (packed.din, packed.dv):
        raise ValueError(
            f"inputs have {x.shape[1]}/{v.shape[1]} columns, the weights were packed for {packed.din}/{packed.dv}"
        )
    if x.device.type == "cpu":
        return fused_nerf_mlp_ref(x, v, packed)
    if x.device.type != "cuda":
        raise ValueError(f"fused_nerf_mlp_fwd runs on cpu or cuda, not {x.device}")
    _check_kernel_args(x, v, packed)
    lib = _kernel_lib()
    for got, want, what in (
        (packed.weights.numel(), lib.xr_fused_nerf_mlp_fwd_weight_elems(), "weights"),
        (packed.biases.numel(), lib.xr_fused_nerf_mlp_fwd_bias_elems(), "biases"),
    ):
        if got != want:
            raise ValueError(f"packed {what} hold {got} elements, the kernel expects {want}")
    n = x.shape[0]
    rgb = torch.empty((n, 3), dtype=torch.float32, device=x.device)
    sigma = torch.empty((n,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.xr_fused_nerf_mlp_fwd(
            x.data_ptr(), x.shape[1], v.data_ptr(), v.shape[1], n,
            packed.weights.data_ptr(), packed.biases.data_ptr(),
            rgb.data_ptr(), sigma.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_nerf_mlp_fwd launch failed: {lib.xr_cuda_error_string(err).decode()} ({err})"
        )
    fused_nerf_mlp_fwd.launches += 1
    return rgb, sigma


fused_nerf_mlp_fwd.launches = 0

