"""flax's compute ``dtype`` for the port's networks.

Every network and field of the JAX package takes ``dtype``, flax's compute
dtype. With ``jnp.bfloat16`` the parameters stay f32; each ``nn.Dense``,
``nn.Conv`` and ``nn.Embed`` casts its input, kernel and bias to ``dtype``,
the product comes out in ``dtype`` and the bias is added in ``dtype``; the
module casts its outputs back to f32 where the JAX code does. The helpers
here are ``nn.Dense`` and ``nn.Conv`` as subclasses of torch's layers,
with their f32 parameters and names. At f32 (the default) each is the torch
layer's own call, so the f32 path keeps its bits.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def resolve_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """A compute dtype from a ``torch.dtype`` or its name (``"float32"``,
    ``"bfloat16"``, ``"float16"``, as ``jnp.dtype`` takes names), so a
    config file can name it without importing torch."""
    if isinstance(dtype, torch.dtype) and dtype in DTYPES.values():
        return dtype
    if isinstance(dtype, str) and dtype in DTYPES:
        return DTYPES[dtype]
    raise ValueError(f"unknown compute dtype {dtype!r}; expected one of {sorted(DTYPES)} or their torch dtypes")


def _flax_order(y: torch.Tensor, bias: Optional[torch.Tensor], dtype: torch.dtype, ndim: int) -> torch.Tensor:
    """The rounded product plus the bias in ``dtype`` (flax's order; a GEMM
    epilogue would add the bias before rounding)."""
    return y if bias is None else y + bias.to(dtype).reshape(-1, *(1,) * ndim)


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=dtype)`` over ``nn.Linear``'s f32 parameters
    (the same names, so state dicts are unchanged): in a lower ``dtype`` the
    input, kernel and bias are cast, the product is rounded to ``dtype`` and
    the bias added after it. At f32 (the default) it is ``nn.Linear``.
    ``dtype`` is the compute dtype, not ``nn.Linear``'s parameter dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__(in_features, out_features, bias)
        self.dtype = resolve_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return super().forward(x.float())
        return _flax_order(F.linear(x.to(self.dtype), self.weight.to(self.dtype)), self.bias, self.dtype, 0)


def _conv(layer, conv_nd, x: torch.Tensor, padding) -> torch.Tensor:
    pad = layer.padding if padding is None else padding
    if layer.dtype == torch.float32:
        return conv_nd(x.float(), layer.weight, layer.bias, layer.stride, pad)
    y = conv_nd(x.to(layer.dtype), layer.weight.to(layer.dtype), None, layer.stride, pad)
    return _flax_order(y, layer.bias, layer.dtype, x.dim() - 2)


class Conv2d(nn.Conv2d):
    """flax ``nn.Conv(dtype=dtype)`` over ``nn.Conv2d``'s f32 parameters, in
    :class:`Dense`'s order; ``padding`` in ``forward`` overrides the
    layer's own."""

    def __init__(self, *args, dtype: Union[str, torch.dtype] = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.dtype = resolve_dtype(dtype)

    def forward(self, x: torch.Tensor, padding: Optional[Sequence[int]] = None) -> torch.Tensor:
        return _conv(self, F.conv2d, x, padding)


class Conv3d(nn.Conv3d):
    """:class:`Conv2d` in three dimensions."""

    def __init__(self, *args, dtype: Union[str, torch.dtype] = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.dtype = resolve_dtype(dtype)

    def forward(self, x: torch.Tensor, padding: Optional[Sequence[int]] = None) -> torch.Tensor:
        return _conv(self, F.conv3d, x, padding)
