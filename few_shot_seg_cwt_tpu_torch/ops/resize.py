"""Resize and pool primitives with PyTorch's semantics, as separable matmuls.

The reference uses ``F.interpolate(mode='bilinear', align_corners=True)`` for
every logit zoom and ``nn.AdaptiveAvgPool2d`` for the PPM bins. The JAX
package computes both as ``out = M_h @ x @ M_w^T`` with precomputed
matrices; the port does the same with its own numpy copies of those
matrices, so the two agree to rounding and the inner-loop kernel reads the
very matrices its plain version uses.

Tensors are NHWC (or HWC / HW), as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def interp_matrix_align_corners(out_size: int, in_size: int) -> np.ndarray:
    """(out_size, in_size) bilinear interpolation matrix, align_corners=True.

    Row i holds the weights of output sample i over input samples:
    src = i * (in-1)/(out-1); two taps floor/ceil with linear weights.
    The result is cached and shared: do not write to it.
    """
    m = np.zeros((out_size, in_size), dtype=np.float64)
    if in_size == 1:
        m[:, 0] = 1.0
        return m.astype(np.float32)
    if out_size == 1:
        # align_corners=True maps the single output sample to input index 0
        m[0, 0] = 1.0
        return m.astype(np.float32)
    scale = (in_size - 1) / (out_size - 1)
    for i in range(out_size):
        src = i * scale
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        w_hi = src - lo
        m[i, lo] += 1.0 - w_hi
        m[i, hi] += w_hi
    return m.astype(np.float32)


@functools.lru_cache(maxsize=None)
def adaptive_pool_matrix(out_size: int, in_size: int) -> np.ndarray:
    """(out_size, in_size) averaging matrix matching nn.AdaptiveAvgPool2d.

    Window i covers [floor(i*n/o), ceil((i+1)*n/o)).
    """
    m = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -(-((i + 1) * in_size) // out_size)  # ceil
        m[i, start:end] = 1.0 / (end - start)
    return m.astype(np.float32)


def _sep_apply(x: torch.Tensor, m_h, m_w) -> torch.Tensor:
    """Apply separable row/col matrices (arrays, or tensors of ``x``'s dtype
    and device) to NHWC (or HWC / HW) input."""
    mh = torch.as_tensor(m_h, dtype=x.dtype, device=x.device)
    mw = torch.as_tensor(m_w, dtype=x.dtype, device=x.device)
    if x.ndim == 2:  # (H, W)
        return mh @ x @ mw.T
    if x.ndim == 3:  # (H, W, C)
        t = torch.einsum("oh,hwc->owc", mh, x)
        return torch.einsum("owc,pw->opc", t, mw)
    if x.ndim == 4:  # (N, H, W, C)
        t = torch.einsum("oh,nhwc->nowc", mh, x)
        return torch.einsum("nowc,pw->nopc", t, mw)
    raise ValueError(f"unsupported rank {x.ndim}")


@functools.lru_cache(maxsize=None)
def _device_matrix(kind, out_size: int, in_size: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """``kind(out_size, in_size)`` as a tensor on ``device``, made once and
    shared: do not write to it."""
    return torch.as_tensor(kind(out_size, in_size), dtype=dtype, device=device)


def _matrices(kind, x: torch.Tensor, out_hw: Tuple[int, int]):
    """The row and column matrices ``kind`` takes ``x``'s two spatial dims
    to ``out_hw`` by. A plain tensor gets them from a per-device cache: a
    copy from pageable host memory waits for the device's queue to drain,
    so making them at every call stalls the host at every resize. A traced
    tensor (a ``torch.export`` fake) gets the host arrays, made into
    constants of the trace."""
    (out_h, out_w), h_in, w_in = out_hw, x.shape[-3], x.shape[-2]
    if type(x) is torch.Tensor:
        return (_device_matrix(kind, out_h, h_in, x.dtype, x.device),
                _device_matrix(kind, out_w, w_in, x.dtype, x.device))
    return kind(out_h, h_in), kind(out_w, w_in)


def upsample_bilinear_ac(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear align_corners=True resize over the two spatial dims of NHWC."""
    if (x.shape[-3], x.shape[-2]) == tuple(out_hw):
        return x
    return _sep_apply(x, *_matrices(interp_matrix_align_corners, x, out_hw))


def adaptive_avg_pool(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """nn.AdaptiveAvgPool2d over the two spatial dims of NHWC input."""
    return _sep_apply(x, *_matrices(adaptive_pool_matrix, x, out_hw))


def resize_nearest(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize matching F.interpolate(mode='nearest'): src = floor(i*in/out).

    Takes (H, W) or NHWC / HWC (spatial axes third and second from last).
    """
    out_h, out_w = out_hw
    if x.ndim == 2:
        h_in, w_in = x.shape
        axis_h, axis_w = 0, 1
    else:
        h_in, w_in = x.shape[-3], x.shape[-2]
        axis_h, axis_w = x.ndim - 3, x.ndim - 2
    idx_h = np.floor(np.arange(out_h) * (h_in / out_h)).astype(np.int64)
    idx_w = np.floor(np.arange(out_w) * (w_in / out_w)).astype(np.int64)
    x = torch.index_select(x, axis_h, torch.as_tensor(idx_h, device=x.device))
    return torch.index_select(x, axis_w, torch.as_tensor(idx_w, device=x.device))
