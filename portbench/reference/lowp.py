"""Operand rounding for the references, by precision:

- ``float32``: as it is;
- ``bf16``: each product's operands rounded to bfloat16 (f32 sums), the
  precision that the configurations state for their fused MLPs;
- ``fp8``: the control, one precision below: e4m3 with one scale per tensor
  (its largest value meets the format's largest, 448, as fp8 products are
  run), in the forward's operands and in the backward's: each product's
  cotangent and the operands of its two backward products;
- ``fp8_backward``: the backward alone in fp8, the forward in float32.

A rounding is a callable on the forward's operands; one that rounds the
backward too carries that rounding as ``.grad`` (see :func:`linear`).
Forward rounding passes gradients through unchanged."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = FP8_MAX / t.detach().abs().amax().clamp(min=1e-30)
    return (t.detach() * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to(torch.bfloat16).to(t.dtype)


def _through(rnd: Callable[[torch.Tensor], torch.Tensor]) -> Callable[[torch.Tensor], torch.Tensor]:
    def q(t: torch.Tensor) -> torch.Tensor:
        r = rnd(t)
        return t + (r - t.detach()) if t.requires_grad else r

    return q


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


bf16 = _through(_bf16)
fp8 = _through(_fp8)


def fp8_both(t: torch.Tensor) -> torch.Tensor:
    return fp8(t)


fp8_both.grad = _fp8


def fp8_backward(t: torch.Tensor) -> torch.Tensor:
    return t


fp8_backward.grad = _fp8


class _RoundedLinear(torch.autograd.Function):
    """``x @ w.T`` of the forward-rounded operands; the backward rounds the
    cotangent and both operands of its products with ``grad``."""

    @staticmethod
    def forward(ctx, x, w, q, grad):
        qx, qw = q(x.detach()), q(w.detach())
        ctx.save_for_backward(qx, qw)
        ctx.grad = grad
        return qx @ qw.t()

    @staticmethod
    def backward(ctx, gy):
        qx, qw = ctx.saved_tensors
        r = ctx.grad
        g = r(gy)
        return g @ r(qw), g.t() @ r(qx), None, None


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, q: Callable = exact) -> torch.Tensor:
    """``F.linear(x, w, b)`` ([out, in] weight) at the rounding ``q``; the
    bias's gradient is the f32 sum of the unrounded cotangent."""
    grad = getattr(q, "grad", None)
    if grad is None:
        return F.linear(q(x), q(w), b)
    return _RoundedLinear.apply(x, w, q, grad) + b


def rounding(precision: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The rounding of ``precision``: ``float32``, ``bf16``, ``fp8`` or
    ``fp8_backward``."""
    return {"float32": exact, "bf16": bf16, "fp8": fp8_both, "fp8_backward": fp8_backward}[precision]
