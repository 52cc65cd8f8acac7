"""The control: the reference computed in fp8 where the configuration
computes in bf16.

The configurations compute in bf16: each of the program's Linear layers
takes its input, weight and bias in bf16 and gives its result in bf16, its
attention kernels take and give bf16, and the activations between the
products (the residual stream, the conditioning) are held in bf16. The
next precision down is fp8. Rounding here is to float8 e4m3 under one
scale per tensor (its largest magnitude maps to e4m3's largest, 448), and
the gradient arriving at a rounded value is rounded to e5m2 the same way
(the roundings pass the gradient through unchanged: a straight-through
estimate). Products are formed in fp32.

  * ``Fp8Ops()`` (the train cells' control, an fp8 training recipe): each
    product's operands and result in fp8; everything else in fp32.
  * ``Fp8Ops(activations=True)`` (the sampling cell's control, fp8
    inference): the activations between the products in fp8 as well.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3 = (torch.float8_e4m3fn, 448.0)
E5M2 = (torch.float8_e5m2, 57344.0)


def round_fp8(x: torch.Tensor, fmt=E4M3) -> torch.Tensor:
    """``x`` rounded to an fp8 format under one per-tensor scale, back in
    x's dtype."""
    dtype, largest = fmt
    scale = largest / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


def _e4m3(x):
    return None if x is None else x + (round_fp8(x) - x).detach()


class _RoundGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return round_fp8(grad, E5M2)


def _held(y):
    """A value held in fp8: e4m3 forward, its gradient in e5m2."""
    return _RoundGrad.apply(_e4m3(y))


class Fp8Ops:
    """``maskdit.Fp32Ops`` with fp8 operands and results (and, with
    ``activations``, fp8 activations between the products)."""

    def __init__(self, activations: bool = False):
        self.activations = activations

    def linear(self, x, w, b=None):
        return _held(F.linear(_e4m3(x), _e4m3(w), _e4m3(b)))

    def matmul(self, a, b):
        return _held(_e4m3(a) @ _e4m3(b))

    def conv(self, x, w, b, stride):
        return _held(F.conv2d(_e4m3(x), _e4m3(w), _e4m3(b), stride=stride))

    def act(self, x):
        return _held(x) if self.activations else x
