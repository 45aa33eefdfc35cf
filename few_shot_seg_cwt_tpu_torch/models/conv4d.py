"""4D convolutions over correlation volumes (PyTorch).

Counterpart of ``few_shot_seg_cwt_tpu.models.conv4d`` (reference:
src/model/conv4d.py). Two flavours:

* ``CenterPivotConv4d`` (src:11-62): the 4D kernel restricted to its two
  centre-pivot planes, i.e. a 2D conv over the query plane (``conv1``) plus
  a 2D conv over the support plane (``conv2``). Three layouts:

  - 6D channels-last ``(B, h, w, hs, ws, C)`` (the default when no
    ``flat_dims`` is given; what ``FSS_NCONS_R4=0`` runs): reshape-batched
    ``F.conv2d`` over each plane, with strides (the support grid is pruned
    by the support stride before the query-plane conv, as in JAX);
  - rank-4 channels-last ``(B, hq*wq, hs*ws, C)`` (``bqsc=True``): both
    plane convs are reshape-batched ``F.conv2d`` (cuDNN); the query-plane
    conv runs on the volume's (0, 2, 1, 3) permutation; each conv adds its
    own bias;
  - flat channels-major ``(B, C, hq*wq, hs*ws)``: the hand-written pivot
    kernels of ``ops.cuda_pivot`` (plain version on CPU tensors), with the
    bias sum and the ReLU fused, when a flat-route switch is set and the
    block is 3^4 with padding 1; otherwise the 6D math around one layout
    conversion (the JAX fallback).

  ``swap_roles=True`` applies the query kernel to the support plane and
  vice versa, which is ``swap(conv(swap(x)))`` without the two
  whole-volume swaps.
* ``Conv4d`` / ``conv4d`` (src:65-138): the true stride-1 4D conv
  (``conv4d cv4``), by one of the JAX package's four forward routes chosen
  by ``FSS_CONV4D_IM2COL``: ``q`` (default; k0 support-plane ``F.conv2d``
  with the k1 query-column taps folded into channels), ``qp`` (one conv2d
  with every query tap folded in), ``gemm`` (query-tap im2col, one
  ``torch.matmul`` mixing taps, col2im over the support plane) and
  ``loop``/``0`` (shifted ``F.conv3d`` over the first query axis). The JAX
  package computes these outside any Pallas kernel; here they are cuDNN
  and cuBLAS calls, differentiated by autograd (the JAX custom VJP exists
  only to bound XLA:TPU's compile time). The weight is stored in the
  reference's pre-permuted layout (k0, O, I, k1, k2, k3), so a reference
  ``.pth`` loads with ``load_state_dict``.

On every route the volume meets the weights by the JAX ``_promote`` rule:
bf16 weights (the head under ``use_amp``) cast the volume down and the
block runs bf16, otherwise both meet at the promoted dtype. The int8 modes
are not ported. ``FSS_QPLANE_HWNC`` (a JAX layout probe for XLA:TPU with the
rank-4 route's math) has no route of its own here.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda_pivot import pivot_fwd, pivot_impl, pivot_kernel_available


def check_no_int8() -> None:
    mode = os.environ.get("FSS_NCONS_INT8", "")
    if mode not in ("", "0"):
        raise NotImplementedError(f"FSS_NCONS_INT8={mode}: the int8 consensus "
                                  "is not ported (ROADMAP queue 1 item 12)")


def init_conv_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of every Conv2d and Conv4d in ``module`` as the JAX
    package does it: U(+-1/sqrt(fan_in)) kernels (torch's default bound);
    zero biases for Conv2d, U(+-1/sqrt(fan_in)) for Conv4d."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, Conv4d):
            m.reset_parameters(generator)


def _hwio(conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    return conv.weight.to(dtype).permute(2, 3, 1, 0)    # OIHW -> (3, 3, Ci, Co)


def _promote(x: torch.Tensor, weight: torch.Tensor) -> torch.dtype:
    """The block's compute dtype: bf16 where the weights arrive bf16 (the
    reference's autocast runs its convs in half precision), else the
    promoted dtype of the volume and the weights."""
    if weight.dtype == torch.bfloat16:
        return torch.bfloat16
    return torch.promote_types(x.dtype, weight.dtype)


def _plane_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                stride=1, padding=1) -> torch.Tensor:
    """``F.conv2d`` on NCHW planes in the dtype of ``x``."""
    bias = None if bias is None else bias.to(x.dtype)
    return F.conv2d(x, weight.to(x.dtype), bias, stride=stride, padding=padding)


def conv_query_planes(x: torch.Tensor, weight: torch.Tensor, bias, stride,
                      padding) -> torch.Tensor:
    """Conv over dims (1, 2) of (B, h, w, hs, ws, C), batched over (hs, ws);
    ``weight`` OIHW. The bias lands on the conv's own output, as nn.Conv."""
    b, h, w, hs, ws, c = x.shape
    t = x.permute(0, 3, 4, 5, 1, 2).reshape(b * hs * ws, c, h, w)
    out = _plane_conv(t, weight, bias, tuple(stride), tuple(padding))
    co, oh, ow = out.shape[1:]
    return out.reshape(b, hs, ws, co, oh, ow).permute(0, 4, 5, 1, 2, 3)


def conv_support_planes(x: torch.Tensor, weight: torch.Tensor, bias, stride,
                        padding) -> torch.Tensor:
    """Conv over dims (3, 4) of (B, h, w, hs, ws, C), batched over (h, w)."""
    b, h, w, hs, ws, c = x.shape
    t = x.reshape(b * h * w, hs, ws, c).permute(0, 3, 1, 2)
    out = _plane_conv(t, weight, bias, tuple(stride), tuple(padding))
    co, ohs, ows = out.shape[1:]
    return out.reshape(b, h, w, co, ohs, ows).permute(0, 1, 2, 4, 5, 3)


class CenterPivotConv4d(nn.Module):
    """conv over (hq, wq) + conv over (hs, ws); names as the reference's."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Sequence[int] = (3, 3, 3, 3),
                 stride: Sequence[int] = (1, 1, 1, 1),
                 padding: Sequence[int] = (1, 1, 1, 1), bias: bool = True):
        super().__init__()
        self.out_channels = out_channels
        self.kernel_size, self.stride = tuple(kernel_size), tuple(stride)
        self.padding = tuple(padding)
        self.conv1 = nn.Conv2d(in_channels, out_channels, self.kernel_size[:2],
                               stride=self.stride[:2], padding=self.padding[:2], bias=bias)
        self.conv2 = nn.Conv2d(in_channels, out_channels, self.kernel_size[2:],
                               stride=self.stride[2:], padding=self.padding[2:], bias=bias)

    def forward(self, x: torch.Tensor, swap_roles: bool = False,
                fuse_relu: bool = False,
                flat_dims: Tuple[int, int, int, int] | None = None,
                bqsc: bool = False) -> torch.Tensor:
        check_no_int8()
        dtype = _promote(x, self.conv1.weight)
        x = x.to(dtype)
        if flat_dims is None:
            if bqsc:
                raise ValueError("bqsc layout requires flat_dims=(h, w, hs, ws)")
            out = self._six_d(x, swap_roles)
            return torch.relu(out) if fuse_relu else out
        if self.stride != (1, 1, 1, 1):
            raise ValueError(f"the flat and rank-4 layouts take stride 1 only, "
                             f"got {self.stride}")
        dims = tuple(int(d) for d in flat_dims)
        if bqsc:
            return self._bqsc(x, swap_roles, fuse_relu, dims)
        return self._flat(x, swap_roles, fuse_relu, dims)

    def _six_d(self, x: torch.Tensor, swap_roles: bool, with_bias: bool = True
               ) -> torch.Tensor:
        """(B, h, w, hs, ws, C) -> (B, h', w', hs', ws', Co). Unswapped, the
        query conv runs on the support grid pruned by the support stride;
        swapped, the query kernel convolves the support planes (pruning the
        query grid) and the support kernel the query planes."""
        s, p = self.stride, self.padding
        c1, c2 = self.conv1, self.conv2
        b1 = c1.bias if with_bias else None
        b2 = c2.bias if with_bias else None
        if not swap_roles:
            x1 = x[:, :, :, ::s[2], ::s[3]] if s[2] > 1 or s[3] > 1 else x
            return (conv_query_planes(x1, c1.weight, b1, s[:2], p[:2])
                    + conv_support_planes(x, c2.weight, b2, s[2:], p[2:]))
        x1 = x[:, ::s[2], ::s[3]] if s[2] > 1 or s[3] > 1 else x
        return (conv_support_planes(x1, c1.weight, b1, s[:2], p[:2])
                + conv_query_planes(x, c2.weight, b2, s[2:], p[2:]))

    def _bqsc(self, x: torch.Tensor, swap_roles: bool, fuse_relu: bool,
              dims) -> torch.Tensor:
        """(B, Q, S, C) -> (B, Q, S, Co): cuDNN plane convs on channels-last
        views; each conv keeps its own padding whichever plane it convolves."""
        hq, wq, hs, ws = dims
        b, qn, sn, c = x.shape
        co = self.out_channels
        q_conv, s_conv = (self.conv2, self.conv1) if swap_roles else (self.conv1, self.conv2)
        xs = x.reshape(b * qn, hs, ws, c).permute(0, 3, 1, 2)
        s_out = (_plane_conv(xs, s_conv.weight, s_conv.bias, padding=s_conv.padding)
                 .permute(0, 2, 3, 1).reshape(b, qn, sn, co))
        xq = x.transpose(1, 2).reshape(b * sn, hq, wq, c).permute(0, 3, 1, 2)
        q_out = (_plane_conv(xq, q_conv.weight, q_conv.bias, padding=q_conv.padding)
                 .permute(0, 2, 3, 1).reshape(b, sn, qn, co).transpose(1, 2))
        out = s_out + q_out
        return torch.relu(out) if fuse_relu else out

    def _flat(self, x: torch.Tensor, swap_roles: bool, fuse_relu: bool,
              dims) -> torch.Tensor:
        """(B, C, Q, S) -> (B, Co, Q, S): the pivot kernels where a flat-route
        switch is set and the block is 3^4 with padding 1, else the 6D math
        around one layout conversion (JAX ``_flat``'s fallback)."""
        if self.conv1.bias is not None:
            bias = self.conv1.bias.to(x.dtype) + self.conv2.bias.to(x.dtype)
        else:
            bias = torch.zeros((self.out_channels,), dtype=x.dtype, device=x.device)
        if pivot_impl() is not None and pivot_kernel_available(
                self.kernel_size, self.stride, self.padding):
            kq, ks = _hwio(self.conv1, x.dtype), _hwio(self.conv2, x.dtype)
            wa, wb = (ks, kq) if swap_roles else (kq, ks)
            return pivot_fwd(x, wa, wb, bias, dims, relu=fuse_relu)
        hq, wq, hs, ws = dims
        b = x.shape[0]
        x6 = x.reshape(b, -1, hq, wq, hs, ws).permute(0, 2, 3, 4, 5, 1)
        out = self._six_d(x6, swap_roles, with_bias=False) + bias
        if fuse_relu:
            out = torch.relu(out)
        return out.permute(0, 5, 1, 2, 3, 4).reshape(b, self.out_channels, hq * wq, hs * ws)


# --------------------------------------------------------------------------- #
# the true 4D convolution
# --------------------------------------------------------------------------- #


def conv4d_im2col_mode() -> str:
    """The true 4D conv's forward route from ``FSS_CONV4D_IM2COL``: ``q``
    (unset or empty, the default), ``qp`` (also ``1``), ``gemm`` or
    ``loop`` (also ``0``); anything else raises, with the JAX message."""
    v = os.environ.get("FSS_CONV4D_IM2COL", "q")
    if v == "":
        v = "q"
    if v in ("0", "loop"):
        return "loop"
    if v in ("1", "qp"):
        return "qp"
    if v in ("q", "gemm"):
        return v
    raise ValueError(f"FSS_CONV4D_IM2COL must be '', '0', 'loop', '1', "
                     f"'qp', 'q' or 'gemm', got {v!r}")


def _pad_query(xc: torch.Tensor, p0: int, p1: int) -> torch.Tensor:
    """Zero-pad dims 1 and 2 (the query plane) of a (B, h, w, ...) tensor."""
    return F.pad(xc, (0, 0) * (xc.ndim - 3) + (p1, p1, p0, p0))


def _conv4d_im2col(x: torch.Tensor, kernel: torch.Tensor, fold_all: bool) -> torch.Tensor:
    """Query-plane taps folded into the channels of a support-plane conv2d:
    all k0*k1 taps in one conv (``qp``) or the k1 taps of each of k0 convs
    (``q``). x (B, h, w, hs, ws, Ci), kernel (k0, k1, k2, k3, Ci, Co)."""
    b, h, w, hs, ws, ci = x.shape
    k0, k1, k2, k3, _, co = kernel.shape
    pad_s = (k2 // 2, k3 // 2)
    # channels ahead of the support plane: (B, h, w, Ci, hs, ws)
    xp = _pad_query(x.permute(0, 1, 2, 5, 3, 4), k0 // 2, k1 // 2)

    def splane_conv(taps, kf):
        # taps (B, h, w, n*Ci, hs, ws) in [tap slowest, ci fastest] order;
        # kf (k2, k3, n*Ci, Co)
        o = F.conv2d(taps.reshape(b * h * w, -1, hs, ws), kf.permute(3, 2, 0, 1),
                     padding=pad_s)
        return o.reshape(b, h, w, co, hs, ws)

    if fold_all:
        taps = torch.cat([xp[:, p:p + h, q:q + w] for p in range(k0) for q in range(k1)],
                         dim=3)
        out = splane_conv(taps, kernel.permute(2, 3, 0, 1, 4, 5).reshape(k2, k3, -1, co))
    else:
        out = None
        for p in range(k0):
            taps = torch.cat([xp[:, p:p + h, q:q + w] for q in range(k1)], dim=3)
            o = splane_conv(taps, kernel[p].permute(1, 2, 0, 3, 4).reshape(k2, k3, -1, co))
            out = o if out is None else out + o
    return out.permute(0, 1, 2, 4, 5, 3)


def _conv4d_gemm(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """im2col over the query taps -> one (k0*k1*Ci, k2*k3*Co) matmul ->
    col2im shifted adds over the support plane."""
    b, h, w, hs, ws, ci = x.shape
    k0, k1, k2, k3, _, co = kernel.shape
    p2, p3 = k2 // 2, k3 // 2
    xp = _pad_query(x, k0 // 2, k1 // 2)
    taps = torch.cat([xp[:, p:p + h, q:q + w] for p in range(k0) for q in range(k1)],
                     dim=-1)                                   # (b,h,w,hs,ws,k0*k1*ci)
    km = kernel.permute(0, 1, 4, 2, 3, 5).reshape(k0 * k1 * ci, k2 * k3 * co)
    y = torch.matmul(taps, km).reshape(b, h, w, hs, ws, k2, k3, co)
    yp = F.pad(y, (0, 0, 0, 0, 0, 0, p3, p3, p2, p2))
    out = None
    for r in range(k2):
        for s in range(k3):
            o = yp[:, :, :, r:r + hs, s:s + ws, r, s]
            out = o if out is None else out + o
    return out


def _conv4d_loop(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Sum over the first query-axis offset of ``F.conv3d`` over the other
    three spatial dims."""
    b, h, w, hs, ws, ci = x.shape
    k0, k1, k2, k3, _, co = kernel.shape
    # (B, h, Ci, w, hs, ws), padded along h
    xp = _pad_query(x.permute(0, 1, 5, 2, 3, 4), k0 // 2, 0)
    out = None
    for p in range(k0):
        t = xp[:, p:p + h].reshape(b * h, ci, w, hs, ws)
        o = F.conv3d(t, kernel[p].permute(4, 3, 0, 1, 2),
                     padding=(k1 // 2, k2 // 2, k3 // 2))
        out = o if out is None else out + o
    return out.reshape(b, h, co, w, hs, ws).permute(0, 1, 3, 4, 5, 2)


def conv4d(x: torch.Tensor, kernel: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full stride-1 4D convolution with padding k//2 on every spatial dim.

    x (B, h, w, hs, ws, Ci); kernel (k0, k1, k2, k3, Ci, Co); odd kernels
    only. The route is ``conv4d_im2col_mode()``; all four compute the same
    function (the reference's looped conv3d, src/model/conv4d.py:65-106)."""
    if any(k % 2 != 1 for k in kernel.shape[:4]):
        raise ValueError(f"conv4d supports odd kernels only, got {tuple(kernel.shape[:4])}")
    mode = conv4d_im2col_mode()
    dtype = _promote(x, kernel)
    x, kernel = x.to(dtype), kernel.to(dtype)
    if mode == "gemm":
        out = _conv4d_gemm(x, kernel)
    elif mode == "loop":
        out = _conv4d_loop(x, kernel)
    else:
        out = _conv4d_im2col(x, kernel, fold_all=(mode == "qp"))
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


class Conv4d(nn.Module):
    """True 4D convolution (stride 1). ``weight`` keeps the reference's
    layout (k0, O, I, k1, k2, k3); ``swap_roles=True`` is the plane-swapped
    application, ``swap(conv(swap(x), K))`` = ``conv(x, K with its spatial
    axes in the order (k2, k3, k0, k1))``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Sequence[int] = (3, 3, 3, 3),
                 padding: Sequence[int] = (1, 1, 1, 1), bias: bool = True):
        super().__init__()
        k = tuple(kernel_size)
        self.kernel_size, self.padding = k, tuple(padding)
        self.out_channels = out_channels
        self.weight = nn.Parameter(torch.empty(k[0], out_channels, in_channels, k[1], k[2], k[3]))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Kernel and bias U(+-1/sqrt(fan_in)), fan_in = Ci * k0*k1*k2*k3 (the
        JAX variance-scaling 1/3 fan_in uniform and ``_uniform_bias_init``)."""
        fan_in = self.weight.shape[2] * math.prod(self.kernel_size)
        bound = 1.0 / math.sqrt(fan_in)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                self.bias.uniform_(-bound, bound, generator=generator)

    def kernel(self) -> torch.Tensor:
        """The weight as (k0, k1, k2, k3, Ci, Co)."""
        return self.weight.permute(0, 3, 4, 5, 2, 1)

    def forward(self, x: torch.Tensor, swap_roles: bool = False) -> torch.Tensor:
        kernel = self.kernel()
        if swap_roles:
            kernel = kernel.permute(2, 3, 0, 1, 4, 5)
        return conv4d(x, kernel, self.bias)
