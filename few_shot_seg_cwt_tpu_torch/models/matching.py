"""Neighbourhood-consensus matching (PyTorch).

Counterpart of ``few_shot_seg_cwt_tpu.models.matching`` (reference:
src/model/match.py and src/model/base/spatial_context.py):

* ``NeighConsensus`` (src:56-85): 4D conv + ReLU blocks, centre-pivot
  (``conv "red"``) or true 4D (``conv "cv4"``), run symmetrically;
* ``MatchNet`` (src:88-183): cosine correlation -> mutual matching ->
  consensus -> mutual matching -> temperature-softmax readout of support
  values, with the spatial context encoder (``sce``), ignore masks and the
  cycle-consistency mask (``cyc``);
* ``SpatialContextEncoder``: local self-similarity (one Gram matmul and a
  static window gather instead of the reference's per-pixel loop) concat
  the feature, through a 1x1 conv and a ReLU.

Each consensus stack takes one route, ``NeighConsensus.route``: a
centre-pivot stack whose blocks the pivot kernels take (3^4, stride 1,
padding 1) runs the flat (B, C, Q, S) route through them; a ``cv4`` stack,
or a centre-pivot stack they do not take, runs the 6D channels-last
(B, h, w, hs, ws, C) route, whose symmetric form is the reference's
stack(x) + swap(stack(swap(x))); a centre-pivot stack under
``FSS_NCONS_INT8`` runs the rank-4 (B, Q, S, C) route, whose plane convs
are the ones the JAX package quantizes. Per-block recompute is on by
default, save on the rank-4 route.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops.corr import (get_corr, l2norm, masked_attention_readout, mutual_matching,
                        mutual_matching_bqsc, mutual_matching_flat)
from ..ops.cuda_pivot import pivot_takes
from ..ops.quant import ncons_int8_mode
from ..utils.tracing import span
from .conv4d import CenterPivotConv4d, Conv4d
from .msm import pointwise

CONV4D = {"red": CenterPivotConv4d, "cv4": Conv4d}


def _swap_planes(x: torch.Tensor) -> torch.Tensor:
    """Swap the query and support planes of (B, h, w, hs, ws, C)."""
    return x.permute(0, 3, 4, 1, 2, 5)


def block_remat_default(cfg, cv_type: str) -> bool:
    """Per-block recompute in the backward: cfg ``remat_blocks`` wins; by
    default on, save for a centre-pivot stack under ``FSS_NCONS_INT8`` (the
    rank-4 route, as JAX's policy)."""
    want = cfg.get("remat_blocks", None)
    if want is not None:
        return bool(want)
    return not (cv_type == "red" and ncons_int8_mode())


class NeighConsensus(nn.Module):
    """Stack of 4D conv blocks; ``conv.{2i}`` are the convs and
    ``conv.{2i+1}`` the ReLUs of the reference's Sequential (fused into the
    centre-pivot blocks on the flat and rank-4 routes)."""

    def __init__(self, kernel_sizes: Sequence[int] = (3, 3, 3),
                 channels: Sequence[int] = (10, 10, 1), symmetric_mode: bool = True,
                 conv: str = "red", in_channel: int = 1, block_remat: bool = True):
        super().__init__()
        if conv not in CONV4D:
            raise ValueError(f"conv4d {conv!r}: 'red' or 'cv4'")
        self.kernel_sizes = tuple(kernel_sizes)
        self.symmetric_mode = symmetric_mode
        self.conv_type = conv
        self.block_remat = block_remat
        layers, c_in = [], in_channel
        for k, ch in zip(kernel_sizes, channels):
            layers += [CONV4D[conv](c_in, ch, kernel_size=(k,) * 4, padding=(k // 2,) * 4),
                       nn.ReLU()]
            c_in = ch
        self.conv = nn.Sequential(*layers)

    def route(self) -> str:
        """The stack's route for this call: "r4" for a centre-pivot stack
        under ``FSS_NCONS_INT8``, "flat" for one whose every block the pivot
        kernels take, "6d" otherwise (every ``cv4`` stack)."""
        if self.conv_type != "red":
            return "6d"
        if ncons_int8_mode():
            return "r4"
        if all(pivot_takes((k,) * 4, (1,) * 4, (k // 2,) * 4) for k in self.kernel_sizes):
            return "flat"
        return "6d"

    def _run(self, blk: nn.Module, *args) -> torch.Tensor:
        if self.block_remat and torch.is_grad_enabled():
            # recompute the block in the backward: only its input stays live
            return checkpoint(blk, *args, use_reentrant=False)
        return blk(*args)

    def _stack(self, x: torch.Tensor, dims, swap_roles: bool, bqsc: bool) -> torch.Tensor:
        for blk in list(self.conv)[::2]:
            x = self._run(blk, x, swap_roles, True, dims, bqsc)
        return x

    def _stack6(self, x: torch.Tensor) -> torch.Tensor:
        """6D route: (B, h, w, hs, ws, C) through every block and ReLU."""
        for blk in list(self.conv)[::2]:
            if self.conv_type == "red":
                x = self._run(blk, x, False, True)
            else:
                x = torch.relu(self._run(blk, x, False))
        return x

    def _symmetric(self, x: torch.Tensor, dims, bqsc: bool) -> torch.Tensor:
        dims = tuple(int(d) for d in dims)
        out = self._stack(x, dims, False, bqsc)
        if self.symmetric_mode:
            out = out + self._stack(x, dims, True, bqsc)
        return out

    def bqsc(self, x: torch.Tensor, dims) -> torch.Tensor:
        """Rank-4 route: (B, Q, S, C) -> (B, Q, S, C_out)."""
        with span("consensus"):
            return self._symmetric(x, dims, True)

    def forward(self, x: torch.Tensor, flat_dims=None) -> torch.Tensor:
        """x (B, h, w, hs, ws, C) on the 6D route, or flat (B, C, Q, S) with
        ``flat_dims`` = (hq, wq, hs, ws): through the pivot kernels on the
        flat route, else converted once around the 6D stack."""
        with span("consensus"):
            if flat_dims is None:
                if self.symmetric_mode:
                    return self._stack6(x) + _swap_planes(self._stack6(_swap_planes(x)))
                return self._stack6(x)
            if self.route() == "flat":
                return self._symmetric(x, flat_dims, False)
            b, c = x.shape[:2]
            hq, wq, hs, ws = (int(d) for d in flat_dims)
            out = self(x.reshape(b, c, hq, wq, hs, ws).permute(0, 2, 3, 4, 5, 1))
            return out.permute(0, 5, 1, 2, 3, 4).reshape(b, out.shape[-1], hq * wq, hs * ws)


@torch.no_grad()
def live_consensus(head: nn.Module, bias: float = 0.1) -> None:
    """Set every bias of each ``NeighConsensus`` under ``head`` to ``bias``.

    A seeded consensus with zero biases can be dead: its last ReLU zeroes
    every output, and every head gradient is 0. Checks and tests that draw
    a head from a seed and need its gradients call this first."""
    for m in head.modules():
        if isinstance(m, NeighConsensus):
            for name, p in m.named_parameters():
                if name.endswith("bias"):
                    p.fill_(bias)


@functools.lru_cache(maxsize=None)
def _window_gather_indices(h: int, w: int, ksz: int) -> Tuple[np.ndarray, np.ndarray]:
    """(h*w, ksz*ksz) flat indices into an (h*w,) axis and their validity."""
    pad = ksz // 2
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    di, dj = np.meshgrid(np.arange(-pad, pad + 1), np.arange(-pad, pad + 1), indexing="ij")
    ni = ii.reshape(-1, 1) + di.reshape(1, -1)
    nj = jj.reshape(-1, 1) + dj.reshape(1, -1)
    valid = (ni >= 0) & (ni < h) & (nj >= 0) & (nj < w)
    return np.where(valid, ni * w + nj, 0).astype(np.int64), valid


def spatial_descriptor(x: torch.Tensor, ksz: int) -> torch.Tensor:
    """Local self-similarity: (B, h, w, C) -> (B, h, w, ksz*ksz) with
    descriptor[n, t] = <x[n], x[neighbour t of n]>, 0 outside the map."""
    b, h, w, c = x.shape
    flat = x.reshape(b, h * w, c).float()
    gram = torch.bmm(flat, flat.transpose(1, 2))
    idx, valid = _window_gather_indices(h, w, ksz)
    idx = torch.as_tensor(idx, device=x.device)
    gathered = torch.gather(gram, 2, idx[None].expand(b, -1, -1))
    gathered = torch.where(torch.as_tensor(valid, device=x.device), gathered,
                           torch.zeros((), dtype=gathered.dtype, device=x.device))
    return gathered.reshape(b, h, w, ksz * ksz)


class SpatialContextEncoder(nn.Module):
    """[x, normalised local self-similarity] -> 1x1 conv -> ReLU, NHWC;
    ``embeddingFea.0`` is the reference's conv."""

    def __init__(self, in_dim: int = 2048, kernel_size: int = 25, hidden_dim: int = 2048):
        super().__init__()
        self.kernel_size = kernel_size
        self.embeddingFea = nn.Sequential(
            nn.Conv2d(in_dim + kernel_size * kernel_size, hidden_dim, 1), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gs = spatial_descriptor(x, self.kernel_size)
        gs = gs / torch.sqrt(torch.sum(gs ** 2, dim=-1, keepdim=True) + 1e-6)
        cat = torch.cat([x, gs.to(x.dtype)], dim=-1)
        return torch.relu(pointwise(self.embeddingFea[0], cat))


class MatchNet(nn.Module):
    """Correlation filtering + attention readout (reference names:
    ``NeighConsensus.conv.*``, ``SpatialContextEncoder.embeddingFea.0``)."""

    def __init__(self, temp: float = 3.0, cv_type: str = "red", in_channel: int = 1,
                 sce: bool = False, cyc: bool = False, sym_mode: bool = True,
                 cv_kernels: Sequence[int] = (3, 3, 3),
                 cv_channels: Sequence[int] = (10, 10, 1), ass_drop: float = 0.1,
                 block_remat: bool = True, feat_dim: int = 2048):
        super().__init__()
        self.temp, self.cv_type = temp, cv_type
        self.in_channel = in_channel
        self.sce, self.cyc, self.ass_drop = sce, cyc, ass_drop
        if sce:
            self.SpatialContextEncoder = SpatialContextEncoder(feat_dim, 25, 2048)
        self.NeighConsensus = NeighConsensus(cv_kernels, cv_channels, sym_mode,
                                             cv_type, in_channel, block_remat)

    def run_match_model(self, corr4d: torch.Tensor) -> torch.Tensor:
        """6D pipeline: (B, h, w, hs, ws, C) in and out."""
        corr4d = mutual_matching(corr4d)
        corr4d = self.NeighConsensus(corr4d)
        return mutual_matching(corr4d)

    def run_match_model_flat(self, corr: torch.Tensor, dims) -> torch.Tensor:
        """(B, C, Q, S) in, (B, Q, S) filtered correlation out, on the
        consensus's route (flat, rank-4 or 6D)."""
        hq, wq, hs, ws = (int(d) for d in dims)
        b, c = corr.shape[:2]
        route = self.NeighConsensus.route()
        if route == "flat":
            corr = mutual_matching_flat(corr)
            corr = self.NeighConsensus(corr, flat_dims=(hq, wq, hs, ws))
            return mutual_matching_flat(corr)[:, 0]
        if route == "r4":
            xr = (corr.reshape(b, hq * wq, hs * ws, 1) if c == 1
                  else corr.permute(0, 2, 3, 1))
            return self.run_match_model_bqsc(xr, dims)
        x6 = corr.reshape(b, c, hq, wq, hs, ws).permute(0, 2, 3, 4, 5, 1)
        return self.run_match_model(x6)[..., 0].reshape(b, hq * wq, hs * ws)

    def run_match_model_bqsc(self, xr: torch.Tensor, dims) -> torch.Tensor:
        """(B, Q, S, C) in, (B, Q, S) filtered correlation out."""
        xr = mutual_matching_bqsc(xr)
        xr = self.NeighConsensus.bqsc(xr, dims)
        return mutual_matching_bqsc(xr)[..., 0]

    def forward(self, fq_fea: torch.Tensor, fs_fea: torch.Tensor, v: torch.Tensor,
                s_mask: Optional[torch.Tensor] = None,
                ig_mask: Optional[torch.Tensor] = None, use_cyc: bool = False,
                deterministic: bool = True, ret_corr: bool = False,
                generator: Optional[torch.Generator] = None):
        """fq_fea, fs_fea (B, h, w, C) query and support features; v (B, h, w,
        Cv) or (B, N_s, Cv) support values; s_mask (B, h, w) support labels
        for the cycle mask; ig_mask (B, N_s) bool support pixels to ignore.
        Returns the readout (B, h, w, Cv), and with ``ret_corr`` also the
        filtered correlation (B, h, w, h, w). The cycle mask's dropout draws
        from ``generator`` (torch's default where None) when ``use_cyc`` and
        not ``deterministic``."""
        b, h, w, _ = fq_fea.shape
        fq = l2norm(fq_fea, dim=-1)
        fs = l2norm(fs_fea, dim=-1)
        if self.sce:
            fq = self.SpatialContextEncoder(fq)
            fs = self.SpatialContextEncoder(fs)
        corr = get_corr(fq, fs)                              # (B, Q, S)
        corr2d = self.run_match_model_flat(corr[:, None], (h, w, h, w))
        if ig_mask is not None:
            corr2d = torch.where(ig_mask[:, None, :], torch.full_like(corr2d, 1e-4), corr2d)
        if self.cyc and use_cyc:
            inconsistent = self.run_cyc(corr2d, s_mask, deterministic, generator)
            corr2d = corr2d + inconsistent[:, None, :].to(corr2d.dtype) * (-1000.0)
        weighted_v = self._readout(corr2d, v, h, w)
        if ret_corr:
            return weighted_v, corr2d.reshape(b, h, w, h, w)
        return weighted_v

    def corr_forward(self, corr4d: torch.Tensor, v: torch.Tensor, ret_attn: bool = False):
        """Filter a pre-built volume (B, h, w, hs, ws, L) and read out v."""
        b, h, w, hs, ws, ch = corr4d.shape
        if ch != self.in_channel:
            raise ValueError(f"{tuple(corr4d.shape)}: {self.in_channel} channels expected")
        flat = corr4d.permute(0, 5, 1, 2, 3, 4).reshape(b, ch, h * w, hs * ws)
        return self.corr_forward_flat(flat, v, (h, w, hs, ws), ret_attn)

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

    def run_cyc(self, corr2d: torch.Tensor, s_mask: torch.Tensor, deterministic: bool,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Cycle-consistency mask (B, N_s): 1 where support -> best query ->
        best support lands on another label, through dropout (rate
        ``ass_drop``) unless deterministic."""
        b, _, n_s = corr2d.shape
        s_mask = s_mask.reshape(b, n_s)
        k2q = torch.argmax(corr2d, dim=1)                    # best query per support px
        q2k = torch.argmax(corr2d, dim=2)                    # best support per query px
        remap = torch.gather(q2k, 1, k2q)                    # support -> support
        remap_mask = torch.gather(s_mask, 1, remap)
        inconsistent = (s_mask != remap_mask).float()
        if deterministic or self.ass_drop <= 0:
            return inconsistent
        keep = 1.0 - self.ass_drop
        draw = torch.rand(inconsistent.shape, generator=generator, device=inconsistent.device)
        return torch.where(draw < keep, inconsistent / keep, torch.zeros_like(inconsistent))
