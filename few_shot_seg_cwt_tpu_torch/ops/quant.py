"""int8 quantization for the consensus-volume convolutions.

Counterpart of ``few_shot_seg_cwt_tpu.ops.quant``. Two modes of
``FSS_NCONS_INT8``, read each time a consensus stack runs; a centre-pivot
stack under either runs the rank-4 route, whose plane convolutions
(``models.conv4d.CenterPivotConv4d._bqsc``) are the ones quantized, as in
JAX:

* ``fake``: both operands of each plane conv go through
  ``dequant(quant(x))`` (per tensor) and the conv runs at the incoming
  dtype: the accuracy cost of int8 volumes, at unchanged speed;
* ``dot``: ``qconv2d``, a real int8 convolution. The volume is quantized
  per tensor, the kernel per output channel (those scales factor out of
  the contraction exactly); the plane is unfolded (im2col, int8) and
  multiplied by the kernel in ``torch._int_mm`` with int32 accumulation,
  which is exact (at most 9 * Ci * 127^2 a sum), and rescaled to fp32 in
  the epilogue. The backward is the straight-through estimator at the
  dequantized point, run at ``grad_dtype`` from the int8 residuals, so the
  saved tensors are int8 too.

Quantization: symmetric, round half to even (``torch.round``, as
``jnp.round``), clipped to [-127, 127]; a scale is max(|x|, 1e-12) / 127
in fp32.

Source note: the JAX package's integer conv is ``conv_general_dilated``
with ``preferred_element_type=int32``, which XLA lowers without a Pallas
kernel, so this is a plain torch op, not a hand-written kernel. PyTorch
has no CUDA int8 ``conv2d``; ``torch._int_mm`` is its int8 GEMM. On the
card it wants M > 16 and K, N multiples of 8, so K = 9 * Ci and N = Co
are padded with zeros (Co is 10, 1 or 16 on these heads) and M is padded
past 16; the CPU runs the same op. ``INT_MM_CALLS`` counts the ``_int_mm``
calls made on CUDA tensors.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch
import torch.nn.functional as F

# _int_mm calls on CUDA tensors since the last reset (the chip check reads it)
INT_MM_CALLS = 0


def ncons_int8_mode() -> str:
    """'' (off, the default) | 'fake' | 'dot', from ``FSS_NCONS_INT8``."""
    v = os.environ.get("FSS_NCONS_INT8", "")
    if v in ("", "0", "off"):
        return ""
    if v in ("fake", "dot"):
        return v
    raise ValueError(f"FSS_NCONS_INT8 must be 'fake' or 'dot', got {v!r}")


def _scale_max(x: torch.Tensor, dims=None) -> torch.Tensor:
    a = x.float().abs()
    amax = a.amax() if dims is None else a.amax(dim=dims, keepdim=True)
    return torch.clamp(amax, min=1e-12) / 127.0


def quantize_tensor(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: (q, scale) with x ~= q * scale."""
    s = _scale_max(x)
    q = torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)
    return q, s


def quantize_per_co(k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of an OIHW kernel (Co first, the
    port's layout; the JAX function takes HWIO with Co last): (q, (Co,)
    scales)."""
    s = _scale_max(k, dims=tuple(range(1, k.ndim)))          # (Co, 1, ..., 1)
    q = torch.clamp(torch.round(k.float() / s), -127, 127).to(torch.int8)
    return q, s.reshape(-1)


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        q, s = quantize_tensor(x)
        return (q.float() * s).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def fake_quant(x: torch.Tensor) -> torch.Tensor:
    """dequant(quant(x)) at x's dtype, with a straight-through gradient."""
    return _FakeQuant.apply(x)


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def int8_conv2d(xq: torch.Tensor, kq: torch.Tensor, padding: Tuple[int, int]) -> torch.Tensor:
    """The exact int32 result of an int8 NCHW x OIHW stride-1 conv: an
    im2col of the padded plane (int8) times the kernel in
    ``torch._int_mm``, K = 9 Ci and N = Co padded to multiples of 8 and M
    past 16 with zeros."""
    global INT_MM_CALLS
    n, ci, h, w = xq.shape
    co, _, kh, kw = kq.shape
    ph, pw = padding
    xp = F.pad(xq, (pw, pw, ph, ph))
    oh, ow = h + 2 * ph - kh + 1, w + 2 * pw - kw + 1
    cols = torch.stack([xp[:, :, i:i + oh, j:j + ow] for i in range(kh) for j in range(kw)],
                       dim=2)                                 # (N, Ci, kh*kw, oh, ow)
    a = cols.permute(0, 3, 4, 1, 2).reshape(n * oh * ow, ci * kh * kw)
    b = kq.reshape(co, ci * kh * kw).t()
    m, k = a.shape
    mp, kp, np_ = max(_round_up(m, 8), 24), _round_up(k, 8), _round_up(co, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, co):
        b = F.pad(b, (0, np_ - co, 0, kp - k))
    if a.is_cuda:
        INT_MM_CALLS += 1
    out = torch._int_mm(a.contiguous(), b.contiguous())[:m, :co]    # int32
    return out.reshape(n, oh, ow, co).permute(0, 3, 1, 2)


class _QConv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, padding, grad_dtype):
        xq, sx = quantize_tensor(x)
        kq, sk = quantize_per_co(k)
        out = int8_conv2d(xq, kq, padding).float() * (sx * sk.reshape(1, -1, 1, 1))
        ctx.save_for_backward(xq, sx, kq, sk)
        ctx.padding, ctx.grad_dtype = padding, grad_dtype
        ctx.dtypes = (x.dtype, k.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        xq, sx, kq, sk = ctx.saved_tensors
        dt = ctx.grad_dtype
        x_deq = xq.to(dt) * sx.to(dt)
        k_deq = kq.to(dt) * sk.reshape(-1, 1, 1, 1).to(dt)
        g = g.to(dt)
        dx = torch.nn.grad.conv2d_input(tuple(xq.shape), k_deq, g, padding=ctx.padding)
        dk = torch.nn.grad.conv2d_weight(x_deq, tuple(kq.shape), g, padding=ctx.padding)
        return dx.to(ctx.dtypes[0]), dk.to(ctx.dtypes[1]), None, None


def qconv2d(x: torch.Tensor, k: torch.Tensor, padding: Tuple[int, int],
            grad_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A stride-1 2D conv executed in int8 (int32 accumulation), fp32 out.

    x (N, Ci, H, W), k (Co, Ci, kh, kw). Forward: both operands quantized,
    the integer conv, the rescale. Backward: the STE gradient at the
    dequantized operands (``dx`` the transposed conv, ``dk`` the weight
    gradient), convs at ``grad_dtype``, from the int8 residuals."""
    return _QConv2d.apply(x, k, tuple(int(p) for p in padding), grad_dtype)
