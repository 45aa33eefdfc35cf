"""The reference's products, in fp32 or, for the control, in TF32.

TF32 keeps fp32's exponent and 10 bits of its mantissa: the tensor cores
round both operands of a product to it and accumulate in fp32. The control
(``lower_precision``) does the same by rounding the operands of every conv
and matrix product to TF32 (nearest, ties to even) before an fp32 product,
so it reads alike on the card and on the CPU. TF32 on the card stays off
either way (``torch.backends``, set by the harness).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

_TF32 = contextvars.ContextVar("reference_tf32", default=False)


@contextlib.contextmanager
def lower_precision():
    """Within the block, the reference's products take TF32 operands."""
    token = _TF32.set(True)
    try:
        yield
    finally:
        _TF32.reset(token)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 mantissa bits), as fp32."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class _RoundOperand(torch.autograd.Function):
    """TF32 operand in the forward; its gradient passes as it is (the
    product's backward rounds what it reads, see ``_RoundCotangent``)."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundCotangent(torch.autograd.Function):
    """Identity in the forward; the cotangent that the product's backward
    multiplies goes to TF32."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


def _product(fn, *operands):
    if not _TF32.get():
        return fn(*operands)
    return _RoundCotangent.apply(fn(*(_RoundOperand.apply(x) for x in operands)))


def conv2d(x, w, bias=None, stride=1, padding=0, dilation=1):
    out = _product(lambda a, b: F.conv2d(a, b, None, stride=stride, padding=padding,
                                         dilation=dilation), x, w)
    return out if bias is None else out + bias.reshape(1, -1, 1, 1)


def einsum(eq, a, b):
    return _product(lambda x, y: torch.einsum(eq, x, y), a, b)


def matmul(a, b):
    return _product(torch.matmul, a, b)
