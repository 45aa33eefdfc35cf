"""4D convolutions over correlation volumes (PyTorch).

Counterpart of ``few_shot_seg_cwt_tpu.models.conv4d`` (reference:
src/model/conv4d.py). Two flavours:

* ``CenterPivotConv4d`` (src:11-62): the 4D kernel restricted to its two
  centre-pivot planes, i.e. a 2D conv over the query plane (``conv1``) plus
  a 2D conv over the support plane (``conv2``). Three layouts, one per
  consensus route (``models.matching.NeighConsensus.route`` picks it):

  - 6D channels-last ``(B, h, w, hs, ws, C)`` (the default when no
    ``flat_dims`` is given): reshape-batched ``F.conv2d`` over each plane,
    with strides (the support grid is pruned by the support stride before
    the query-plane conv, as in JAX);
  - flat channels-major ``(B, C, hq*wq, hs*ws)``: the hand-written pivot
    kernels of ``ops.cuda_pivot`` (plain version on CPU tensors), with the
    bias sum and the ReLU fused, where the block is 3^4 with padding 1
    (``pivot_takes``); otherwise the 6D math around one layout conversion
    (the JAX fallback);
  - rank-4 channels-last ``(B, hq*wq, hs*ws, C)`` (``bqsc=True``), the
    int8 consensus's layout: both plane convs are reshape-batched
    ``F.conv2d`` on quantized operands (below); the query-plane conv runs
    on the volume's (0, 2, 1, 3) permutation; each conv adds its own bias.

  ``swap_roles=True`` applies the query kernel to the support plane and
  vice versa, which is ``swap(conv(swap(x)))`` without the two
  whole-volume swaps.
* ``Conv4d`` / ``conv4d`` (src:65-138): the true stride-1 4D conv
  (``conv4d cv4``), on the JAX package's default route ``q``: k0
  support-plane ``F.conv2d`` with the k1 query-column taps folded into
  channels (cuDNN, differentiated by autograd; the JAX custom VJP exists
  only to bound XLA:TPU's compile time). A CUDA fp32 call with a 5^4
  kernel at (Ci, Co) = (1, 1) or (9, 9) (the CHM head's CHM4d and CHM6d)
  that autograd does not record runs the hand-written ``hough4d`` kernel
  instead (``ops.cuda_hough``; CHM training keeps the cuDNN path). The
  weight is stored in the reference's pre-permuted layout (k0, O, I, k1,
  k2, k3), so a reference ``.pth`` loads with ``load_state_dict``.

On every layout the volume meets the weights by the JAX ``_promote`` rule:
bf16 weights (the head under ``use_amp``) cast the volume down and the
block runs bf16, otherwise both meet at the promoted dtype.

The int8 modes (``FSS_NCONS_INT8=fake|dot``, ``ops.quant``; read when the
block runs) reach the rank-4 layout's two plane convs only, as in JAX (its
``models/conv4d.py:278-300``): ``fake`` convolves fake-quantized operands,
``dot`` runs ``qconv2d`` (int8 ``torch._int_mm`` on an im2col of the
plane).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda_hough import hough4d, hough4d_takes
from ..ops.cuda_pivot import pivot_fwd, pivot_takes
from ..ops.quant import fake_quant, ncons_int8_mode, qconv2d
from ..utils.tracing import count, span


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


def _rank4_plane_conv(x: torch.Tensor, conv: nn.Conv2d, int8_mode: str) -> torch.Tensor:
    """One plane conv of the rank-4 layout, NCHW in the dtype of ``x``, under
    ``FSS_NCONS_INT8`` (``ops.quant``): ``fake`` quantizes both operands
    per tensor and convolves the dequantized values; ``dot`` runs
    ``qconv2d`` (int8 operands, int32 sums, per-channel kernel scales). The
    bias is added after, as the JAX route adds it."""
    if not int8_mode:
        return _plane_conv(x, conv.weight, conv.bias, padding=conv.padding)
    weight = conv.weight.to(x.dtype)
    if int8_mode == "dot":
        out = qconv2d(x, weight, conv.padding, x.dtype).to(x.dtype)
    else:
        out = F.conv2d(fake_quant(x), fake_quant(weight), None, padding=conv.padding)
    if conv.bias is not None:
        out = out + conv.bias.to(out.dtype).reshape(1, -1, 1, 1)
    return out


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
        # a span of its own: under per-block recompute it runs again in the backward
        with span("consensus"):
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
        mode = ncons_int8_mode()
        xs = x.reshape(b * qn, hs, ws, c).permute(0, 3, 1, 2)
        s_out = (_rank4_plane_conv(xs, s_conv, mode)
                 .permute(0, 2, 3, 1).reshape(b, qn, sn, co))
        xq = x.transpose(1, 2).reshape(b * sn, hq, wq, c).permute(0, 3, 1, 2)
        q_out = (_rank4_plane_conv(xq, q_conv, mode)
                 .permute(0, 2, 3, 1).reshape(b, sn, qn, co).transpose(1, 2))
        out = s_out + q_out
        return torch.relu(out) if fuse_relu else out

    def _flat(self, x: torch.Tensor, swap_roles: bool, fuse_relu: bool,
              dims) -> torch.Tensor:
        """(B, C, Q, S) -> (B, Co, Q, S): the pivot kernels where they take
        the block (3^4, padding 1), else the 6D math around one layout
        conversion (JAX ``_flat``'s fallback)."""
        if self.conv1.bias is not None:
            bias = self.conv1.bias.to(x.dtype) + self.conv2.bias.to(x.dtype)
        else:
            bias = torch.zeros((self.out_channels,), dtype=x.dtype, device=x.device)
        if pivot_takes(self.kernel_size, self.stride, self.padding):
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
    """The true 4D conv's route, always ``q``; the benchmark reads it."""
    return "q"


def _conv4d_q(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The query plane's k1 column taps folded into the channels of k0
    support-plane ``F.conv2d``, summed. x (B, h, w, hs, ws, Ci), kernel
    (k0, k1, k2, k3, Ci, Co)."""
    b, h, w, hs, ws, ci = x.shape
    k0, k1, k2, k3, _, co = kernel.shape
    # channels ahead of the support plane, the query plane zero-padded by
    # k0 // 2 and k1 // 2: (B, h', w', Ci, hs, ws)
    xp = F.pad(x.permute(0, 1, 2, 5, 3, 4),
               (0, 0, 0, 0, 0, 0, k1 // 2, k1 // 2, k0 // 2, k0 // 2))
    out = None
    for p in range(k0):
        # taps (B, h, w, k1*Ci, hs, ws) in [tap slowest, ci fastest] order
        taps = torch.cat([xp[:, p:p + h, q:q + w] for q in range(k1)], dim=3)
        kf = kernel[p].permute(1, 2, 0, 3, 4).reshape(k2, k3, -1, co)
        o = F.conv2d(taps.reshape(b * h * w, -1, hs, ws), kf.permute(3, 2, 0, 1),
                     padding=(k2 // 2, k3 // 2)).reshape(b, h, w, co, hs, ws)
        out = o if out is None else out + o
    return out.permute(0, 1, 2, 4, 5, 3)


def conv4d(x: torch.Tensor, kernel: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full stride-1 4D convolution with padding k//2 on every spatial dim.

    x (B, h, w, hs, ws, Ci); kernel (k0, k1, k2, k3, Ci, Co); odd kernels
    only. The function is the reference's looped conv3d
    (src/model/conv4d.py:65-106). Each call adds 1 to the counter
    ``conv4d_q`` (``utils.tracing``). The calls ``hough4d_takes`` (CUDA
    fp32, 5^4 kernel at (Ci, Co) = (1, 1) or (9, 9), nothing for autograd
    to record) run the ``hough4d`` kernel, with the bias added at its
    store; the others ``_conv4d_q``."""
    if any(k % 2 != 1 for k in kernel.shape[:4]):
        raise ValueError(f"conv4d supports odd kernels only, got {tuple(kernel.shape[:4])}")
    count("conv4d_q")
    dtype = _promote(x, kernel)
    x, kernel = x.to(dtype), kernel.to(dtype)
    if hough4d_takes(x, kernel, bias):
        return hough4d(x, kernel, None if bias is None else bias.to(dtype))
    out = _conv4d_q(x, kernel)
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
