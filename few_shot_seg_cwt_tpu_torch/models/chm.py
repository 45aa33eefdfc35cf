"""Convolutional Hough matching (CHM) layers and the CHMLearner head (PyTorch).

Counterpart of ``few_shot_seg_cwt_tpu.models.chm`` (reference:
src/model/base/chm.py, chm_kernel.py and src/model/match.py:191-244):

* ``kernel_groups``: 4D kernel entries grouped by geometric keys ('iso':
  offset distance; 'psi': (d_max, d_min, d_off)), one learnable scalar a
  group, spread over the kernel as w / len(group); the group order is the
  reference's, which weight import relies on;
* ``CHM4d``: the parameter-shared 4D conv (1 in / 1 out channel) through
  ``models.conv4d.conv4d``;
* ``CHM6d``: the 3x3 scale pairs folded into the channels of ONE
  ``conv4d`` with a block-sparse (5, 5, 5, 5, 9, 9) kernel, the flipped
  scale convolution as a linear mix of scale pairs (as the JAX package
  builds it);
* ``CHMLearner``: multi-scale 3x3 conv embeddings -> 6D correlation ->
  CHM6d -> sigmoid -> scale max-pool -> 4D upsample -> CHM4d -> softplus ->
  mutual nearest-neighbour filter -> temperature-softmax readout.

The 4D and 6D convolutions run through ``conv4d``: in evaluation on the
card the hand-written ``hough4d`` kernel (``ops.cuda_hough``), with the
scalar bias added at its store; under autograd cuDNN convolutions (the
JAX package's are XLA ops, outside any Pallas kernel). Parameter names
follow the flax tree: ``scale_conv_{i}.weight``, ``chm6d.param_{i}``, ``chm6d.bias``,
``chm4d.weight``, ``chm4d.bias``. Initialisers are the JAX package's, drawn
from an explicit ``torch.Generator``. ``CHMLearner.forward`` runs its phases
inside spans of ``utils.tracing``: ``chm_corr`` (scale convs, correlations,
4D resizes), ``chm6d``, ``chm_pool`` (sigmoid, scale max-pool, 4D upsample),
``chm4d`` and ``chm_readout`` (softplus, mutual filter, readout).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.corr import masked_attention_readout, mutual_nn_filter
from ..ops.resize import upsample_bilinear_ac
from ..utils.tracing import span
from .conv4d import conv4d

SCALES = (0.5, 1.0, 2.0)


def _dist2(a: Tuple[int, int], b: Tuple[int, int]) -> int:
    return (a[0] - b[0]) ** 2 + (a[1] - b[1]) ** 2


@functools.lru_cache(maxsize=None)
def kernel_groups(ksz: int, ktype: str) -> Optional[Tuple[Tuple[int, ...], ...]]:
    """Flat-index groups of 4D kernel entries sharing one weight, in the
    reference's dict insertion order (i3 slowest ... i0 fastest); None for
    ktype 'full'."""
    if ktype == "full":
        return None
    center = (ksz // 2, ksz // 2)
    groups: Dict[str, List[int]] = {}
    for si in range(ksz):
        for sj in range(ksz):
            for ti in range(ksz):
                for tj in range(ksz):
                    d_tail = _dist2((si, sj), center)
                    d_head = _dist2((ti, tj), center)
                    d_off = _dist2((si, sj), (ti, tj))
                    if ktype == "iso":
                        key = f"{d_off}"
                    elif ktype == "psi":
                        key = f"{max(d_head, d_tail)}_{min(d_head, d_tail)}_{d_off}"
                    else:
                        raise ValueError(ktype)
                    groups.setdefault(key, []).append(si * ksz**3 + sj * ksz**2 + ti * ksz + tj)
    return tuple(tuple(v) for v in groups.values())


@functools.lru_cache(maxsize=None)
def _group_index(groups, ksz: int) -> np.ndarray:
    """The group of every flat kernel entry."""
    gid = np.full((ksz**4,), -1, np.int64)
    for g, idx in enumerate(groups):
        gid[np.asarray(idx)] = g
    assert (gid >= 0).all()
    return gid


def _register_groups(module: nn.Module, groups, ksz: int) -> None:
    """The group of every kernel entry and each group's size as buffers
    that move with the module: made on the host at each call, each would be
    a copy from pageable memory that waits for the device's queue."""
    module.register_buffer("group_index", torch.as_tensor(_group_index(groups, ksz)),
                           persistent=False)
    module.register_buffer("group_sizes", torch.tensor([float(len(g)) for g in groups]),
                           persistent=False)


def _spread_weights(weights: torch.Tensor, index: torch.Tensor, sizes: torch.Tensor,
                    extra_div: float = 1.0) -> torch.Tensor:
    """(n_groups,) -> (ksz^4,) kernel with w / (len(group) * extra_div) per
    entry; ``index`` is the group of every entry, ``sizes`` each group's
    size (``_register_groups``)."""
    return (weights / (sizes.to(weights.dtype) * extra_div))[index]


def _shared_weight_init(groups, n_scale: int, generator) -> torch.Tensor:
    """|N(0, 1)| * 1e-3 * len(group) * n_scale (JAX ``_shared_weight_init``
    and ``_shared_weight_init_scaled``)."""
    w = torch.randn(len(groups), generator=generator).abs() * 1e-3
    return w * torch.tensor([float(len(g) * n_scale) for g in groups])


def _uniform(shape, bound: float, generator) -> torch.Tensor:
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


class CHM4d(nn.Module):
    """Parameter-shared 4D Hough matching conv (1 in / 1 out channel) on
    (B, h, w, hs, ws, 1)."""

    def __init__(self, ksz: int = 5, ktype: str = "psi", use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ksz, self.ktype = ksz, ktype
        self.groups = kernel_groups(ksz, ktype)
        if self.groups is None:
            # the reference takes |w| once at init only (base/chm.py:111)
            self.weight = nn.Parameter(torch.randn(ksz**4, generator=generator).abs())
        else:
            self.weight = nn.Parameter(_shared_weight_init(self.groups, 1, generator))
            _register_groups(self, self.groups, ksz)
        if use_bias:
            # shared kernels keep _ConvNd's uniform bias, the full kernel a
            # zero bias (base/chm.py:109-112)
            self.bias = nn.Parameter(torch.zeros(()) if self.groups is None
                                     else _uniform((), 1.0 / math.sqrt(ksz**4), generator))
        else:
            self.bias = None

    def kernel(self) -> torch.Tensor:
        flat = (self.weight if self.groups is None
                else _spread_weights(self.weight, self.group_index, self.group_sizes))
        return flat.reshape((self.ksz,) * 4 + (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv4d(x, self.kernel(), self.bias)


def _scale_groups(ktype: str) -> List[List[int]]:
    if ktype == "psi":
        return [[4], [0, 8], [2, 6], [1, 3, 5, 7]]
    if ktype == "iso":
        return [[0, 4, 8], [2, 6], [1, 3, 5, 7]]
    raise ValueError(ktype)


@functools.lru_cache(maxsize=None)
def _scale_mix_index(s1: int, s2: int, ksz6d: int) -> np.ndarray:
    """(s1*s2 in, s1*s2 out) -> scale-kernel offset da*ksz6d+db feeding that
    channel pair, or ksz6d**2 (a zero block) where none does: the flipped
    scale conv out[a, b] += K[da, db] * x[a + da - pad, b + db - pad]."""
    pad = ksz6d // 2
    idx = np.full((s1 * s2, s1 * s2), ksz6d * ksz6d, np.int64)
    for a in range(s1):
        for b2 in range(s2):
            for da in range(ksz6d):
                for db in range(ksz6d):
                    ai, bi = a + da - pad, b2 + db - pad
                    if 0 <= ai < s1 and 0 <= bi < s2:
                        idx[ai * s2 + bi, a * s2 + b2] = da * ksz6d + db
    return idx


class CHM6d(nn.Module):
    """6D Hough matching over (B, s, s, h, w, hs, ws), kernel (3, 3, k, k, k, k):
    one shared 4D kernel per scale offset, scaled by 1 / len(scale group)."""

    def __init__(self, ksz6d: int = 3, ksz4d: int = 5, ktype: str = "psi",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ksz6d, self.ksz4d, self.ktype = ksz6d, ksz4d, ktype
        self.groups = kernel_groups(ksz4d, ktype)
        if self.groups is None:
            raise ValueError("CHM6d: the full 6D kernel is not supported (as in the reference)")
        self.scale_groups = _scale_groups(ktype)
        for i, sg in enumerate(self.scale_groups):
            self.register_parameter(f"param_{i}", nn.Parameter(
                _shared_weight_init(self.groups, len(sg), generator)))
        # torch _ConvNd bias bound, fan_in = 3 * 3 * 5**4 (as JAX hard-codes it)
        self.bias = nn.Parameter(_uniform((), 1.0 / math.sqrt(3 * 3 * 5**4), generator))
        _register_groups(self, self.groups, ksz4d)
        n = len(SCALES)
        self.register_buffer("scale_mix", torch.as_tensor(_scale_mix_index(n, n, ksz6d)),
                             persistent=False)

    def channel_kernel(self, nsp_side: Tuple[int, int]) -> torch.Tensor:
        """The block-sparse (k, k, k, k, s1*s2, s1*s2) kernel of the one conv4d."""
        k4 = self.ksz4d
        blocks = [None] * (self.ksz6d * self.ksz6d)
        for i, sg in enumerate(self.scale_groups):
            spread = _spread_weights(getattr(self, f"param_{i}"), self.group_index,
                                     self.group_sizes, extra_div=len(sg))
            for j in sg:
                blocks[j] = spread
        k6 = torch.stack(blocks + [torch.zeros_like(blocks[0])])   # (ksz6d^2 + 1, k^4)
        idx = (self.scale_mix if tuple(nsp_side) == (len(SCALES),) * 2
               else torch.as_tensor(_scale_mix_index(*nsp_side, self.ksz6d), device=k6.device))
        kch = k6[idx]                                              # (nsp, nsp, k^4)
        nsp = idx.shape[0]
        return kch.permute(2, 0, 1).reshape((k4,) * 4 + (nsp, nsp))

    def forward(self, corr: torch.Tensor) -> torch.Tensor:
        b, s1, s2, h, w, hs, ws = corr.shape
        nsp = s1 * s2
        x = corr.reshape(b, nsp, h, w, hs, ws).permute(0, 2, 3, 4, 5, 1)
        out = conv4d(x, self.channel_kernel((s1, s2)), self.bias)
        return out.permute(0, 5, 1, 2, 3, 4).reshape(b, s1, s2, h, w, hs, ws)


def interpolate4d(t: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear (align_corners) resize of both planes of (B, h1, w1, h2, w2)."""
    b, h1, w1, h2, w2 = t.shape
    x = upsample_bilinear_ac(t.reshape(b, h1, w1, h2 * w2), (size, size))   # query plane
    x = x.reshape(b, size * size, h2, w2).permute(0, 2, 3, 1)
    x = upsample_bilinear_ac(x, (size, size))                              # support plane
    return x.permute(0, 3, 1, 2).reshape(b, size, size, size, size)


def _conv3x3_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def build_correlation6d(src_feat: torch.Tensor, trg_feat: torch.Tensor,
                        scales: Sequence[float], convs) -> torch.Tensor:
    """Multi-scale cosine correlations -> (B, S, S, side, side, side, side),
    clamped at 0 (reference Correlation.build_correlation6d,
    src/model/base/correlation.py:27-67)."""
    b, side = src_feat.shape[:2]
    srcs, trgs = [], []
    for scale, conv in zip(scales, convs):
        s = round(side * math.sqrt(scale))
        srcs.append(_conv3x3_nhwc(conv, upsample_bilinear_ac(src_feat, (s, s))))
        trgs.append(_conv3x3_nhwc(conv, upsample_bilinear_ac(trg_feat, (s, s))))
    vols = []
    for sf in srcs:
        sflat = sf.reshape(b, -1, sf.shape[-1])
        snorm = torch.linalg.vector_norm(sflat, dim=2, keepdim=True)
        for tf in trgs:
            tflat = tf.reshape(b, -1, tf.shape[-1])
            tnorm = torch.linalg.vector_norm(tflat, dim=2, keepdim=True)
            corr = torch.bmm(sflat, tflat.transpose(1, 2)) / torch.clamp(
                snorm * tnorm.transpose(1, 2), min=1e-30)
            ss, ts = sf.shape[1], tf.shape[1]
            vols.append(interpolate4d(corr.reshape(b, ss, ss, ts, ts), side))
    n = len(scales)
    stacked = torch.stack(vols).reshape((n, n, b) + (side,) * 4)
    return torch.clamp(stacked.permute(2, 0, 1, 3, 4, 5, 6), min=0.0)


def _lecun_normal_(conv: nn.Conv2d, generator) -> None:
    """flax's default conv kernel init: truncated normal of variance
    1 / fan_in (lecun_normal)."""
    fan_in = conv.weight.shape[1] * conv.weight.shape[2] * conv.weight.shape[3]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(conv.weight, std=std, a=-2 * std, b=2 * std, generator=generator)


class CHMLearner(nn.Module):
    """The CHM head: query and support features (B, side, side, C_in) and
    support values (B, 2*side, 2*side, Cv) -> readout (B, 2*side, 2*side,
    Cv). ``in_dim`` is the tap's width (flax infers it, torch cannot);
    the scale convs give ``feat_dim // 4`` channels."""

    def __init__(self, ktype: str = "psi", feat_dim: int = 2048, temp: float = 20.0,
                 in_dim: int = 2048, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ktype, self.feat_dim, self.temp = ktype, feat_dim, temp
        for i in range(len(SCALES)):
            conv = nn.Conv2d(in_dim, feat_dim // 4, 3, padding=1, bias=False)
            _lecun_normal_(conv, generator)
            setattr(self, f"scale_conv_{i}", conv)
        self.chm6d = CHM6d(ksz6d=3, ksz4d=5, ktype=ktype, generator=generator)
        self.chm4d = CHM4d(ksz=5, ktype=ktype, generator=generator)

    def forward(self, src_feat: torch.Tensor, trg_feat: torch.Tensor, v: torch.Tensor,
                ig_mask: Optional[torch.Tensor] = None, ret_corr: bool = False):
        convs = [getattr(self, f"scale_conv_{i}") for i in range(len(SCALES))]
        with span("chm_corr"):
            corr = build_correlation6d(src_feat, trg_feat, SCALES, convs)
        b, s, _, h, w = corr.shape[:5]
        with span("chm6d"):
            corr = self.chm6d(corr)
        with span("chm_pool"):
            corr = torch.sigmoid(corr)
            corr = torch.amax(corr.reshape(b, s * s, h, w, h, w), dim=1)   # scale max-pool
            corr = interpolate4d(corr, h * 2)
        with span("chm4d"):
            corr = self.chm4d(corr.reshape(b, 2 * h, 2 * w, 2 * h, 2 * w, 1))[..., 0]
        with span("chm_readout"):
            n = (2 * h) * (2 * w)
            corr2d = mutual_nn_filter(F.softplus(corr).reshape(b, n, n))
            out = masked_attention_readout(corr2d, v, temp=self.temp, ig_mask=ig_mask)
            out = out.reshape(b, 2 * h, 2 * w, -1)
        return (out, corr2d) if ret_corr else out
