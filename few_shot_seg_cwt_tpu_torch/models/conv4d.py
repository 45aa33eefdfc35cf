"""Centre-pivot 4D convolution over correlation volumes (PyTorch).

Counterpart of ``few_shot_seg_cwt_tpu.models.conv4d.CenterPivotConv4d``
(reference: src/model/conv4d.py:11-62): the 4D kernel restricted to its two
centre-pivot planes, i.e. a 2D conv over the query plane (``conv1``) plus a
2D conv over the support plane (``conv2``). Two layouts:

* rank-4 channels-last ``(B, hq*wq, hs*ws, C)`` (``bqsc=True``): both plane
  convs are reshape-batched ``F.conv2d`` (cuDNN); the query-plane conv runs
  on the volume's (0, 2, 1, 3) permutation; each conv adds its own bias;
* flat channels-major ``(B, C, hq*wq, hs*ws)``: the hand-written pivot
  kernels of ``ops.cuda_pivot`` (plain version on CPU tensors), with the
  bias sum and the ReLU fused.

``swap_roles=True`` applies the query kernel to the support plane and vice
versa, which is ``swap(conv(swap(x)))`` without the two whole-volume swaps;
the symmetric NeighConsensus runs on it. The 6D channels-last route, the
true ``Conv4d`` (``conv4d cv4``) and the int8 modes are not ported.
"""

from __future__ import annotations

import math
import os
from typing import Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.cuda_pivot import pivot_conv_flat, pivot_kernel_available

SIX_D_ROUTE = ("the 6D channels-last consensus route is not ported (ROADMAP "
               "queue 1 item 7); use the rank-4 route (default) or the flat "
               "route (FSS_PIVOT_MXU=1 / FSS_PIVOT_PALLAS=1)")


def check_no_int8() -> None:
    mode = os.environ.get("FSS_NCONS_INT8", "")
    if mode not in ("", "0"):
        raise NotImplementedError(f"FSS_NCONS_INT8={mode}: the int8 consensus "
                                  "is not ported (ROADMAP queue 1 item 12)")


def init_conv_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of every Conv2d in ``module`` as the JAX package does it:
    U(+-1/sqrt(fan_in)) kernels (torch's default bound) and zero biases."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


def _hwio(conv: nn.Conv2d) -> torch.Tensor:
    return conv.weight.permute(2, 3, 1, 0)          # OIHW -> (3, 3, Ci, Co)


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
        if flat_dims is None:
            raise NotImplementedError(SIX_D_ROUTE)
        if self.stride != (1, 1, 1, 1):
            raise ValueError(f"the flat and rank-4 layouts take stride 1 only, "
                             f"got {self.stride}")
        check_no_int8()
        dims = tuple(int(d) for d in flat_dims)
        if bqsc:
            return self._bqsc(x, swap_roles, fuse_relu, dims)
        return self._flat(x, swap_roles, fuse_relu, dims)

    def _bqsc(self, x: torch.Tensor, swap_roles: bool, fuse_relu: bool,
              dims) -> torch.Tensor:
        """(B, Q, S, C) -> (B, Q, S, Co): cuDNN plane convs on channels-last
        views; each conv keeps its own padding whichever plane it convolves."""
        hq, wq, hs, ws = dims
        b, qn, sn, c = x.shape
        co = self.out_channels
        q_conv, s_conv = (self.conv2, self.conv1) if swap_roles else (self.conv1, self.conv2)
        xs = x.reshape(b * qn, hs, ws, c).permute(0, 3, 1, 2)
        s_out = s_conv(xs).permute(0, 2, 3, 1).reshape(b, qn, sn, co)
        xq = x.transpose(1, 2).reshape(b * sn, hq, wq, c).permute(0, 3, 1, 2)
        q_out = q_conv(xq).permute(0, 2, 3, 1).reshape(b, sn, qn, co).transpose(1, 2)
        out = s_out + q_out
        return torch.relu(out) if fuse_relu else out

    def _flat(self, x: torch.Tensor, swap_roles: bool, fuse_relu: bool,
              dims) -> torch.Tensor:
        """(B, C, Q, S) -> (B, Co, Q, S) through the pivot kernels."""
        if not pivot_kernel_available(self.kernel_size, self.stride, self.padding):
            raise NotImplementedError(f"kernel {self.kernel_size} / padding "
                                      f"{self.padding} on the flat route: {SIX_D_ROUTE}")
        kq, ks = _hwio(self.conv1), _hwio(self.conv2)
        wa, wb = (ks, kq) if swap_roles else (kq, ks)
        if self.conv1.bias is not None:
            bias = self.conv1.bias + self.conv2.bias
        else:
            bias = torch.zeros((self.out_channels,), dtype=x.dtype, device=x.device)
        return pivot_conv_flat(x, wa, wb, bias, dims, relu=fuse_relu)
