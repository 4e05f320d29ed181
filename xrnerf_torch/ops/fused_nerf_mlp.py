"""Fused vanilla-NeRF MLP, forward and backward: wrappers, plain versions,
kernel bindings and the autograd op.

Port of ``xrnerf_tpu/ops/pallas/fused_nerf_mlp.py``. The kernels are the
hand-written CUDA ``xrnerf_torch/csrc/fused_nerf_mlp_fwd.cu`` and
``fused_nerf_mlp_bwd.cu``; their source notes give the designs. Numerics
are the TPU kernels': bf16 operands, f32 accumulation and biases, hidden
activations rounded to bf16, sigma from the f32 accumulator, rgb in f32;
the backward rounds each dpre to bf16 before its products and sums bias
gradients from the f32 dpre (``_bwd_kernel``).

- :func:`pack_params_f32` packs a ``NerfMLP``'s weights into one flat
  weight and one flat bias buffer with ``torch.cat``/``F.pad``, so on live
  parameters autograd routes the buffers' gradients back to each
  ``nn.Linear`` (the JAX package's jnp packing, :382-440). It holds the
  operands of the TPU pack (``_packed_shapes``, :281-295), stored [out, in]
  (K contiguous, as the tensor cores read a B operand), with the 384-wide
  ``feature|alpha`` head split into a 256-row feature block and an 8-row
  alpha block, and the rgb head padded to 8 rows rather than 128.
  :func:`pack_params` is the same pack with the weights cast to bf16 once,
  as the serving path caches it.
- :func:`weight_image` lays the bf16 pack out as the kernels read it: 64 x 64
  blocks in the 128-byte swizzled order of ``wgmma``'s shared-memory
  descriptors, so that the kernels stream weights with one-dimensional bulk
  copies (``fused_nerf_mlp_common.cuh`` describes the layout). A pack made
  on the card carries its image, so a pack that is cached (serving) or used
  by a forward and its backward (training) builds it once.
  :func:`bwd_schedule` sizes the backward's grids.
- :func:`fused_nerf_mlp_fwd` / :func:`fused_nerf_mlp_bwd` run the forward
  and backward: the plain version for a CPU tensor, the kernel for a CUDA
  tensor (raising if the kernel cannot build or launch — there is no
  fallback). ``.launches`` on each counts kernel launches.
- :func:`fused_nerf_mlp_ref` / :func:`fused_nerf_mlp_bwd_ref` are the plain
  versions: the same functions in torch ops, rounded at the same points,
  with bf16 operands emulated as f32 values.
- :class:`FusedNerfMLPFunction` is the differentiable op (``_fused_core``'s
  custom VJP, :308-376): f32 weight and bias buffers in, f32 gradients out.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_BF = torch.bfloat16
_HEAD = 8  # alpha / rgb heads padded to one tensor-core n-tile
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
    # weight_image(weights), kept beside a pack that is launched more than once
    # (with_image); a pack whose weights are replaced must drop it
    image: Optional[torch.Tensor] = None


def _layout(width: int, px: int, pv: int) -> Tuple[List[Tuple[str, int, int]], List[Tuple[str, int]]]:
    """(name, rows, cols) of each packed matrix and (name, len) of each bias,
    in buffer order. Must match the offsets in ``fused_nerf_mlp_common.cuh``."""
    hv = width // 2
    mats = [("w0", width, px)]
    mats += [(f"w{i}", width, width) for i in range(1, 5)]
    mats += [("w5h", width, width), ("w5x", width, px), ("w6", width, width), ("w7", width, width)]
    mats += [("wf", width, width), ("wa", _HEAD, width), ("wvf", hv, width), ("wvv", hv, pv)]
    mats += [("wrgb", _HEAD, hv)]
    biases = [(f"b{i}", width) for i in range(8)]
    biases += [("bf", width), ("ba", _HEAD), ("bv", hv), ("brgb", _HEAD)]
    return mats, biases


def pack_params_f32(sd: Mapping[str, torch.Tensor], din: int, dv: int) -> PackedNerfMLP:
    """Pack a ``NerfMLP``'s parameters (``pts_0.weight`` [out, in], ...) for
    ``pts_enc`` of width ``din`` and ``views_enc`` of width ``dv`` into f32
    buffers. Differentiable: given live parameters, the buffers keep the
    graph back to them."""

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
    wbuf = torch.cat([m.reshape(-1) for m in mats]).float()
    bbuf = torch.cat([t.reshape(-1) for t in biases]).float()
    return PackedNerfMLP(wbuf, bbuf, width, din, dv, px, pv)


def pack_params(sd: Mapping[str, torch.Tensor], din: int, dv: int) -> PackedNerfMLP:
    """The kernel's pack: :func:`pack_params_f32` with the weights cast to
    bf16 once (``_cast_weights``, :298-305); on the card, with the kernels'
    weight image beside it."""
    p = pack_params_f32(sd, din, dv)
    p = p._replace(weights=p.weights.to(_BF).contiguous(), biases=p.biases.contiguous())
    return with_image(p) if p.weights.device.type == "cuda" else p


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


_IMAGE_ORDER = ("w0", "w1", "w2", "w3", "w4", "w5h", "w5x", "w6", "w7", "wa", "wf", "wvf", "wvv", "wrgb")
_BLOCK = 64  # rows and columns of one image block: 128-byte rows of bf16


@functools.lru_cache(maxsize=None)
def weight_image_index(width: int, px: int, pv: int) -> np.ndarray:
    """For each element of the weight image, the index of the pack element it
    holds, or the pack's length for padding (read as zero). The image holds
    the matrices in ``_IMAGE_ORDER`` (the forward kernel's streaming order).
    A matrix [O, I] (I padded to a multiple of 64) is cut into blocks of 64
    rows (8 for the heads) x 64 columns, ordered column-block-major; in a
    block, row r is 64 values = eight 16-byte chunks, and chunk q is stored at
    position q ^ (r % 8): the 128-byte swizzle."""
    if width % _BLOCK or px % _BLOCK:
        raise ValueError(f"the weight image needs width and padded pts_enc width in 64s, got {width}/{px}")
    mats, _ = _layout(width, px, pv)
    total = sum(r * c for _, r, c in mats)
    src, o = {}, 0
    for name, r, c in mats:
        src[name] = o + np.arange(r * c, dtype=np.int64).reshape(r, c)
        o += r * c
    pos = np.arange(8)
    parts = []
    for name in _IMAGE_ORDER:
        m = src[name]
        rows, cols = m.shape
        cpad = _ceil_to(cols, _BLOCK)
        m = np.pad(m, ((0, 0), (0, cpad - cols)), constant_values=total)
        rb = min(rows, _BLOCK)
        blocks = m.reshape(rows // rb, rb, cpad // _BLOCK, 8, 8).transpose(2, 0, 1, 3, 4)  # [c, ob, r, q, e]
        q = pos[None, :] ^ (np.arange(rb)[:, None] % 8)  # the chunk stored at [r, position]
        parts.append(np.take_along_axis(blocks, q[None, None, :, :, None], axis=3).reshape(-1))
    return np.concatenate(parts)


_IMAGE_INDEX: Dict[Tuple, torch.Tensor] = {}


def weight_image(packed: PackedNerfMLP) -> torch.Tensor:
    """The kernels' weight image of a bf16 pack (one gather; flat bf16)."""
    key = (packed.width, packed.px, packed.pv, packed.weights.device)
    if key not in _IMAGE_INDEX:
        _IMAGE_INDEX[key] = torch.from_numpy(weight_image_index(*key[:3])).to(key[3])
    return F.pad(packed.weights, (0, 1)).index_select(0, _IMAGE_INDEX[key])


def with_image(packed: PackedNerfMLP) -> PackedNerfMLP:
    """``packed`` with its weight image beside it (made once)."""
    return packed if packed.image is not None else packed._replace(image=weight_image(packed))


KERNEL_TILE = 128  # rows of one CTA tile: two warpgroups of 64
KERNEL_SLAB = 64  # rows of one slab of the backward's scratch
_WGRAD_TILES = 22  # (weight block, 128 output rows) pairs of the weight-gradient pass


def bwd_schedule(n: int, sms: int = 132) -> Tuple[int, int, int, int]:
    """(npad, grid, kchunk, splits) of the backward for ``n`` rows on a card
    with ``sms`` SMs. ``npad``: rows padded to the 128-row tile. ``grid``:
    CTAs of the persistent row pass, at most one per SM, CTA ``i`` walking
    tiles ``i, i + grid, ...``. ``kchunk`` (a multiple of the 64-row slab)
    and ``splits``: the weight-gradient pass cuts the rows into ``splits``
    chunks of ``kchunk``, the last one shorter, each summed into its own f32
    partial; ``splits`` is chosen so that its grid of 22 x ``splits`` CTAs
    fills the card about twice."""
    npad = _ceil_to(max(n, 1), KERNEL_TILE)
    grid = min(npad // KERNEL_TILE, sms)
    slabs = npad // KERNEL_SLAB
    want = max(1, min(slabs, round(2 * sms / _WGRAD_TILES)))
    chunk = -(-slabs // want)
    return npad, grid, chunk * KERNEL_SLAB, -(-slabs // chunk)


def _rb(a: torch.Tensor) -> torch.Tensor:
    """Round to bf16, compute on in f32."""
    return a.to(_BF).float()


def _ref_trunk(x: torch.Tensor, v: torch.Tensor, packed: PackedNerfMLP):
    """The plain forward's pieces: f32 copies of the bf16 weights and f32
    biases (by name), bf16-valued x and v, h0..h7, feat and v1."""
    p = {k: t.float() for k, t in unpack_params(packed).items()}

    def mm(a, name):  # bf16-valued operands, f32 accumulation
        return a @ p[name].t()

    xb = _rb(F.pad(x.float(), (0, packed.px - x.shape[1])))
    vb = _rb(F.pad(v.float(), (0, packed.pv - v.shape[1])))
    hs = [_rb(F.relu(mm(xb, "w0") + p["b0"]))]
    for i in range(1, 8):
        if i == 5:  # the skip input [x | h4] as split matmuls
            pre = mm(hs[-1], "w5h") + mm(xb, "w5x") + p["b5"]
        else:
            pre = mm(hs[-1], f"w{i}") + p[f"b{i}"]
        hs.append(_rb(F.relu(pre)))
    feat = _rb(mm(hs[7], "wf") + p["bf"])
    v1 = _rb(F.relu(mm(feat, "wvf") + mm(vb, "wvv") + p["bv"]))
    return p, xb, vb, hs, feat, v1


def fused_nerf_mlp_ref(
    x: torch.Tensor, v: torch.Tensor, packed: PackedNerfMLP
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (raw_rgb [N, 3], raw_sigma [N]) in f32."""
    p, _, _, hs, _, v1 = _ref_trunk(x, v, packed)
    sigma = (hs[7] @ p["wa"].t() + p["ba"])[:, 0]
    rgb = (v1 @ p["wrgb"].t() + p["brgb"])[:, :3]
    return rgb.contiguous(), sigma.contiguous()


def fused_nerf_mlp_bwd_ref(
    x: torch.Tensor, v: torch.Tensor, g: torch.Tensor, packed: PackedNerfMLP
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward, ``_bwd_kernel`` (:159-271) step by step in the port's
    pack layout: (dx [N, din], dv [N, dv], dw, db) in f32, dw and db flat
    in the pack's order. ``g`` [N, 4] holds d loss / d raw_rgb in columns
    0..2 and d loss / d raw_sigma in column 3. Each dpre is rounded to bf16
    before its products; bias gradients are sums of the f32 dpre."""
    p, xb, vb, hs, feat, v1 = _ref_trunk(x, v, packed)

    def mm_tt(d, h):  # d^T @ h: [out, in] weight gradient, f32 accumulation
        return d.t() @ h

    def masked(h_out, dh):  # the ReLU mask from the bf16 activation
        return torch.where(h_out > 0, dh, torch.zeros_like(dh))

    g = g.float()
    g_rgb = F.pad(g[:, :3], (0, _HEAD - 3))
    g_sig = F.pad(g[:, 3:4], (0, _HEAD - 1))
    dw, db = {}, {}
    # rgb head
    grb = _rb(g_rgb)
    dw["wrgb"], db["brgb"] = mm_tt(grb, v1), g_rgb.sum(0)
    # view branch (the split concat: feature part + view part)
    dpv = masked(v1, grb @ p["wrgb"])
    dpvb = _rb(dpv)
    dw["wvf"], dw["wvv"], db["bv"] = mm_tt(dpvb, feat), mm_tt(dpvb, vb), dpv.sum(0)
    dfeat = dpvb @ p["wvf"]
    dv = dpvb @ p["wvv"]
    # feature and alpha heads
    dfb, gsb = _rb(dfeat), _rb(g_sig)
    dw["wf"], dw["wa"] = mm_tt(dfb, hs[7]), mm_tt(gsb, hs[7])
    db["bf"], db["ba"] = dfeat.sum(0), g_sig.sum(0)
    dh = dfb @ p["wf"] + gsb @ p["wa"]
    # trunk, 7 down to 0 (5: the skip input [x | h4] as split matmuls)
    for i in range(7, -1, -1):
        dpre = masked(hs[i], dh)
        dpb = _rb(dpre)
        db[f"b{i}"] = dpre.sum(0)
        if i == 5:
            dw["w5h"], dw["w5x"] = mm_tt(dpb, hs[4]), mm_tt(dpb, xb)
            dx = dpb @ p["w5x"]
            dh = dpb @ p["w5h"]
        elif i == 0:
            dw["w0"] = mm_tt(dpb, xb)
            dx = dx + dpb @ p["w0"]
        else:
            dw[f"w{i}"] = mm_tt(dpb, hs[i - 1])
            dh = dpb @ p[f"w{i}"]
    mats, biases = _layout(packed.width, packed.px, packed.pv)
    dwbuf = torch.cat([dw[name].reshape(-1) for name, _, _ in mats])
    dbbuf = torch.cat([db[name] for name, _ in biases])
    return dx[:, : x.shape[1]].contiguous(), dv[:, : v.shape[1]].contiguous(), dwbuf, dbbuf


_VP, _CI, _CLL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "fused_nerf_mlp_fwd": [_VP, _CI, _VP, _CI, _CLL, _VP, _VP, _VP, _VP, _VP],
    "fused_nerf_mlp_bwd": [_VP, _CI, _VP, _CI, _VP, _CLL, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                           _VP, _VP, _VP, _VP, _CI, _CI, _CLL, _VP],
}
_LIBS: Dict[str, ctypes.CDLL] = {}


def _kernel_lib(name: str) -> ctypes.CDLL:
    """Build (first call) and bind ``csrc/<name>.cu``."""
    if name not in _LIBS:
        from .build import load_library

        lib = load_library(name)
        fn = getattr(lib, f"xr_{name}")
        fn.argtypes, fn.restype = _ARGTYPES[name], _CI
        counts = ["weight_elems", "bias_elems", "image_elems"]
        if name.endswith("bwd"):
            counts += ["scratch_bytes_per_slab", "mask_bytes_per_cta", "sum_floats_per_cta", "sm_count",
                       "rows_smem_bytes", "wgrad_smem_bytes"]
        else:
            counts += ["smem_bytes"]
        for what in counts:
            f = getattr(lib, f"xr_{name}_{what}")
            f.argtypes, f.restype = [], _CLL
        lib.xr_cuda_error_string.argtypes = [_CI]
        lib.xr_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def _check_pack_size(lib, name: str, packed: PackedNerfMLP) -> None:
    """``packed`` (with its image) is what the built kernel reads."""
    image = packed.image
    if image.dtype != _BF or image.device != packed.weights.device or not image.is_contiguous():
        raise ValueError("the weight image must be a contiguous bfloat16 tensor on the weights' device")
    sizes = ((packed.weights.numel(), "weight_elems"), (packed.biases.numel(), "bias_elems"),
             (image.numel(), "image_elems"))
    for got, what in sizes:
        want = getattr(lib, f"xr_{name}_{what}")()
        if got != want:
            raise ValueError(f"packed {what} hold {got} elements, the kernel expects {want}")


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.xr_cuda_error_string(err).decode()} ({err})")


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


def _check_shapes(x, v, packed: PackedNerfMLP) -> str:
    """Validate pts_enc / views_enc against the pack; returns the device type."""
    if x.dim() != 2 or v.dim() != 2 or x.shape[0] != v.shape[0]:
        raise ValueError(f"expected pts_enc [N, dx] and views_enc [N, dv], got {tuple(x.shape)}, {tuple(v.shape)}")
    if (x.shape[1], v.shape[1]) != (packed.din, packed.dv):
        raise ValueError(
            f"inputs have {x.shape[1]}/{v.shape[1]} columns, the weights were packed for {packed.din}/{packed.dv}"
        )
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the fused NeRF MLP runs on cpu or cuda, not {x.device}")
    return x.device.type


def fused_nerf_mlp_fwd(
    x: torch.Tensor, v: torch.Tensor, packed: PackedNerfMLP
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(raw_rgb [N, 3], raw_sigma [N]) f32 from pts_enc ``x`` [N, dx] and
    views_enc ``v`` [N, dv]: the plain version on the CPU, the CUDA kernel
    on the card."""
    if _check_shapes(x, v, packed) == "cpu":
        return fused_nerf_mlp_ref(x, v, packed)
    _check_kernel_args(x, v, packed)
    lib = _kernel_lib("fused_nerf_mlp_fwd")
    packed = with_image(packed)
    _check_pack_size(lib, "fused_nerf_mlp_fwd", packed)
    n = x.shape[0]
    rgb = torch.empty((n, 3), dtype=torch.float32, device=x.device)
    sigma = torch.empty((n,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.xr_fused_nerf_mlp_fwd(
            x.data_ptr(), x.shape[1], v.data_ptr(), v.shape[1], n,
            packed.image.data_ptr(), packed.biases.data_ptr(),
            rgb.data_ptr(), sigma.data_ptr(), stream,
        )
    _raise_on(lib, err, "fused_nerf_mlp_fwd")
    fused_nerf_mlp_fwd.launches += 1
    return rgb, sigma


fused_nerf_mlp_fwd.launches = 0


def fused_nerf_mlp_bwd(
    x: torch.Tensor, v: torch.Tensor, g: torch.Tensor, packed: PackedNerfMLP
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx [N, din], dv [N, dv], dw, db) in f32 for upstream gradient ``g``
    [N, 4] (rgb 0..2, sigma 3): the plain version on the CPU, the CUDA
    kernel on the card. dw / db are flat, in the pack's order."""
    dev = _check_shapes(x, v, packed)
    if g.shape != (x.shape[0], 4):
        raise ValueError(f"expected g [N, 4], got {tuple(g.shape)}")
    if dev == "cpu":
        return fused_nerf_mlp_bwd_ref(x, v, g, packed)
    _check_kernel_args(x, v, packed)
    if g.device != x.device or g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError("g must be a contiguous float32 tensor on pts_enc's device")
    n = x.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    dw = torch.zeros(packed.weights.numel(), **f32)
    db = torch.zeros(packed.biases.numel(), **f32)
    if n == 0:
        return torch.zeros((0, x.shape[1]), **f32), torch.zeros((0, v.shape[1]), **f32), dw, db
    lib = _kernel_lib("fused_nerf_mlp_bwd")
    packed = with_image(packed)
    _check_pack_size(lib, "fused_nerf_mlp_bwd", packed)
    with torch.cuda.device(x.device):
        sms = lib.xr_fused_nerf_mlp_bwd_sm_count()
    if sms < 1:
        raise RuntimeError("fused_nerf_mlp_bwd: the card did not give its SM count")
    npad, grid, kchunk, splits = bwd_schedule(n, sms)
    dx = torch.empty((n, x.shape[1]), **f32)
    dv = torch.empty((n, v.shape[1]), **f32)
    u8 = dict(dtype=torch.uint8, device=x.device)
    scratch = torch.empty(lib.xr_fused_nerf_mlp_bwd_scratch_bytes_per_slab() * (npad // KERNEL_SLAB), **u8)
    masks = torch.empty(lib.xr_fused_nerf_mlp_bwd_mask_bytes_per_cta() * grid, **u8)
    # one slice per CTA and warp of the row pass, which adds into it tile after tile: it must
    # start zeroed and belong to this launch's grid alone, or the sums are not the same bits
    sums = torch.zeros(lib.xr_fused_nerf_mlp_bwd_sum_floats_per_cta() * grid, **f32)
    wpart = torch.empty(splits * dw.numel(), **f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.xr_fused_nerf_mlp_bwd(
            x.data_ptr(), x.shape[1], v.data_ptr(), v.shape[1], g.data_ptr(), n,
            packed.image.data_ptr(), packed.weights.data_ptr(), packed.biases.data_ptr(),
            dx.data_ptr(), dv.data_ptr(), dw.data_ptr(), db.data_ptr(),
            scratch.data_ptr(), masks.data_ptr(), sums.data_ptr(), wpart.data_ptr(),
            grid, splits, kchunk, stream,
        )
    _raise_on(lib, err, "fused_nerf_mlp_bwd")
    fused_nerf_mlp_bwd.launches += 1
    return dx, dv, dw, db


fused_nerf_mlp_bwd.launches = 0


class FusedNerfMLPFunction(torch.autograd.Function):
    """The fused MLP as an autograd op: ``apply(x, v, weights, biases, meta)``
    with f32 ``x`` [N, din], ``v`` [N, dv] and the f32 buffers of
    :func:`pack_params_f32` (``meta`` = its (width, din, dv, px, pv)).
    Forward casts the weights to bf16 once and runs
    :func:`fused_nerf_mlp_fwd`; backward runs :func:`fused_nerf_mlp_bwd`
    and returns f32 gradients for the weight and bias buffers, plus dx and
    dv where they are asked for."""

    @staticmethod
    def forward(ctx, x, v, weights, biases, meta):
        if weights.dtype != torch.float32 or biases.dtype != torch.float32:
            # a bf16 leaf would round every weight gradient to bf16
            raise TypeError(f"weights and biases must be float32, got {weights.dtype} / {biases.dtype}")
        packed = PackedNerfMLP(weights.to(_BF).contiguous(), biases.contiguous(), *meta)
        if x.device.type == "cuda":  # the kernels' image, made once for this forward and its backward
            packed = with_image(packed)
        rgb, sigma = fused_nerf_mlp_fwd(x, v, packed)
        ctx.save_for_backward(x, v, packed.weights, packed.biases, packed.image)
        ctx.meta = meta
        return rgb, sigma

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_rgb, grad_sigma):
        x, v, wb, bb, image = ctx.saved_tensors
        g = torch.zeros((x.shape[0], 4), dtype=torch.float32, device=x.device)
        if grad_rgb is not None:
            g[:, :3] = grad_rgb
        if grad_sigma is not None:
            g[:, 3] = grad_sigma
        dx, dv, dw, db = fused_nerf_mlp_bwd(x, v, g, PackedNerfMLP(wb, bb, *ctx.meta, image))
        need_x, need_v = ctx.needs_input_grad[:2]
        return (dx if need_x else None), (dv if need_v else None), dw, db, None


def fused_nerf_mlp(
    x: torch.Tensor, v: torch.Tensor, params: Mapping[str, torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable fused MLP over a ``NerfMLP``'s live parameters (named
    as in its state dict): packs them with :func:`pack_params_f32` and
    applies :class:`FusedNerfMLPFunction`. (raw_rgb [N, 3], raw_sigma [N])."""
    p = pack_params_f32(params, x.shape[1], v.shape[1])
    meta = (p.width, p.din, p.dv, p.px, p.pv)
    return FusedNerfMLPFunction.apply(x, v, p.weights, p.biases, meta)
