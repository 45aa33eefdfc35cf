"""Neighbourhood-consensus matching (PyTorch).

Counterpart of ``few_shot_seg_cwt_tpu.models.matching`` (reference:
src/model/match.py) for the centre-pivot stacks:

* ``NeighConsensus`` (src:56-85): 4D conv + ReLU blocks, run symmetrically as
  stack(x) + stack_with_exchanged_kernels(x), the transpose-free form of
  stack(x) + swap(stack(swap(x)));
* ``MatchNet`` (src:88-183): mutual matching -> consensus -> mutual matching
  -> temperature-softmax readout of support values.

Two routes, chosen as the JAX package chooses them: the rank-4
(B, Q, S, C) route with cuDNN plane convs (the default), and the flat
(B, C, Q, S) route through the hand-written pivot kernels when
``FSS_PIVOT_MXU=1`` or ``FSS_PIVOT_PALLAS=1`` is set. The 6D route, the true
4D conv (``cv4``), the spatial context encoder (``sce``) and the
cycle-consistency mask (``cyc``) are not ported (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops.corr import masked_attention_readout, mutual_matching_bqsc, mutual_matching_flat
from ..ops.cuda_pivot import pivot_pallas_active
from .conv4d import SIX_D_ROUTE, CenterPivotConv4d


def ncons_r4_active(cv_type: str) -> bool:
    """True when the rank-4 (B, Q, S, C) consensus route is in effect: the
    default for centre-pivot stacks, unless ``FSS_NCONS_R4=0`` or a flat
    pivot-kernel switch is set."""
    if cv_type != "red" or os.environ.get("FSS_NCONS_R4") == "0":
        return False
    return not pivot_pallas_active()


def block_remat_default(cfg, cv_type: str) -> bool:
    """Per-block recompute in the backward: cfg ``remat_blocks`` wins; by
    default off on the rank-4 route and on elsewhere (the JAX policy)."""
    want = cfg.get("remat_blocks", None)
    if want is not None:
        return bool(want)
    return not ncons_r4_active(cv_type)


def _unported(cv_type: str) -> None:
    if cv_type != "red":
        raise NotImplementedError(f"conv4d {cv_type!r}: the true 4D conv is not "
                                  "ported (ROADMAP queue 1 item 7)")


class NeighConsensus(nn.Module):
    """Stack of centre-pivot 4D conv blocks; ``conv.{2i}`` are the convs and
    ``conv.{2i+1}`` the ReLUs of the reference's Sequential (fused here)."""

    def __init__(self, kernel_sizes: Sequence[int] = (3, 3, 3),
                 channels: Sequence[int] = (10, 10, 1), symmetric_mode: bool = True,
                 conv: str = "red", in_channel: int = 1, block_remat: bool = True):
        super().__init__()
        _unported(conv)
        self.kernel_sizes = tuple(kernel_sizes)
        self.symmetric_mode = symmetric_mode
        self.block_remat = block_remat
        layers, c_in = [], in_channel
        for k, ch in zip(kernel_sizes, channels):
            layers += [CenterPivotConv4d(c_in, ch, (k,) * 4, (1,) * 4, (k // 2,) * 4),
                       nn.ReLU()]
            c_in = ch
        self.conv = nn.Sequential(*layers)

    def _stack(self, x: torch.Tensor, dims, swap_roles: bool, bqsc: bool) -> torch.Tensor:
        for blk in list(self.conv)[::2]:
            if self.block_remat and torch.is_grad_enabled():
                # recompute the block in the backward: only its input stays live
                x = checkpoint(blk, x, swap_roles, True, dims, bqsc, use_reentrant=False)
            else:
                x = blk(x, swap_roles, True, dims, bqsc)
        return x

    def _symmetric(self, x: torch.Tensor, dims, bqsc: bool) -> torch.Tensor:
        dims = tuple(int(d) for d in dims)
        out = self._stack(x, dims, False, bqsc)
        if self.symmetric_mode:
            out = out + self._stack(x, dims, True, bqsc)
        return out

    def bqsc(self, x: torch.Tensor, dims) -> torch.Tensor:
        """Rank-4 route: (B, Q, S, C) -> (B, Q, S, C_out)."""
        return self._symmetric(x, dims, True)

    def forward(self, x: torch.Tensor, flat_dims=None) -> torch.Tensor:
        """Flat route: (B, C, Q, S) -> (B, C_out, Q, S), ``flat_dims`` =
        (hq, wq, hs, ws), through the pivot kernels."""
        if flat_dims is None or not pivot_pallas_active(self.kernel_sizes):
            raise NotImplementedError(SIX_D_ROUTE)
        return self._symmetric(x, flat_dims, False)


class MatchNet(nn.Module):
    """Correlation filtering + attention readout (reference names:
    ``NeighConsensus.conv.*``)."""

    def __init__(self, temp: float = 3.0, cv_type: str = "red", in_channel: int = 1,
                 sce: bool = False, cyc: bool = False, sym_mode: bool = True,
                 cv_kernels: Sequence[int] = (3, 3, 3),
                 cv_channels: Sequence[int] = (10, 10, 1), block_remat: bool = True):
        super().__init__()
        _unported(cv_type)
        if sce or cyc:
            raise NotImplementedError("MatchNet sce / cyc are not ported "
                                      "(ROADMAP queue 1 item 7)")
        self.temp, self.cv_type = temp, cv_type
        self.in_channel = in_channel
        self.cv_kernels = tuple(cv_kernels)
        self.NeighConsensus = NeighConsensus(cv_kernels, cv_channels, sym_mode,
                                             cv_type, in_channel, block_remat)

    def run_match_model_flat(self, corr: torch.Tensor, dims) -> torch.Tensor:
        """(B, C, Q, S) in, (B, Q, S) filtered correlation out."""
        hq, wq, hs, ws = (int(d) for d in dims)
        if pivot_pallas_active(self.cv_kernels):
            corr = mutual_matching_flat(corr)
            corr = self.NeighConsensus(corr, flat_dims=(hq, wq, hs, ws))
            return mutual_matching_flat(corr)[:, 0]
        if ncons_r4_active(self.cv_type):
            b, c = corr.shape[:2]
            xr = (corr.reshape(b, hq * wq, hs * ws, 1) if c == 1
                  else corr.permute(0, 2, 3, 1))
            return self.run_match_model_bqsc(xr, dims)
        raise NotImplementedError(SIX_D_ROUTE)

    def run_match_model_bqsc(self, xr: torch.Tensor, dims) -> torch.Tensor:
        """(B, Q, S, C) in, (B, Q, S) filtered correlation out."""
        xr = mutual_matching_bqsc(xr)
        xr = self.NeighConsensus.bqsc(xr, dims)
        return mutual_matching_bqsc(xr)[..., 0]

    def corr_forward_flat(self, corr: torch.Tensor, v: torch.Tensor, dims,
                          ret_attn: bool = False):
        """Filter a flat channels-major volume (B, L, Q, S) and read out v."""
        if corr.shape[1] != self.in_channel:
            raise ValueError(f"{tuple(corr.shape)}: {self.in_channel} channels expected")
        corr2d = self.run_match_model_flat(corr, dims)
        weighted_v = self._readout(corr2d, v, int(dims[0]), int(dims[1]))
        return (corr2d, weighted_v) if ret_attn else weighted_v

    def corr_forward_bqsc(self, corr: torch.Tensor, v: torch.Tensor, dims,
                          ret_attn: bool = False):
        """Filter a rank-4 channels-last volume (B, Q, S, L) and read out v."""
        if corr.shape[-1] != self.in_channel:
            raise ValueError(f"{tuple(corr.shape)}: {self.in_channel} channels expected")
        corr2d = self.run_match_model_bqsc(corr, dims)
        weighted_v = self._readout(corr2d, v, int(dims[0]), int(dims[1]))
        return (corr2d, weighted_v) if ret_attn else weighted_v

    def _readout(self, corr2d: torch.Tensor, v: torch.Tensor, h: int, w: int):
        out = masked_attention_readout(corr2d, v, temp=self.temp)
        return out.reshape(out.shape[0], h, w, out.shape[-1])
