"""Dynamic fusion heads: per-pixel blend weights predicted from correlations.

Counterpart of ``few_shot_seg_cwt_tpu.models.fusion`` (reference:
src/model/transformer.py:252-374):

* ``DynamicFusion``: one centre-pivot conv (support stride 2) over a
  correlation, the pooled support mask, a 1x1 MLP -> a sigmoid weight map;
* ``FuseNet1`` (the ``fuse`` head): ``_Conv4dStack`` over each of two
  correlations, the support mask and the prediction maps -> a 2-channel
  softmax of blend weights;
* ``FuseNet``: one correlation plus fg/bg correlation summaries -> sigmoid.

``_Conv4dStack`` is CenterPivot(1 -> 16, support stride 2) -> ReLU ->
CenterPivot(16 -> 1) -> ReLU on the 6D channels-last route of
``models/conv4d.py`` (``CenterPivotConv4d._six_d``: cuDNN plane convs, the
support grid pruned by the stride before the query-plane conv), as the
JAX package runs it: it calls the block without ``flat_dims``, so neither
layer reaches the pivot kernels (which take stride 1 only). Tensors are
channels-last: correlations (B, h, w, hs, ws), masks (B, H, W, 1),
prediction maps (B, h, w, C). Reference names: ``conv4d.0`` / ``conv4d.2``
(``conv1``, ``conv2`` each; ``conv4d`` alone in ``DynamicFusion``) and
``att.0`` / ``att.2``; a ``torch.Generator`` draws the JAX initialisers
(U(+-1/sqrt(fan_in)) kernels, zero biases).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .conv4d import CenterPivotConv4d, init_conv_parameters
from .msm import pointwise


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """nn.AvgPool2d(kernel=2, stride=2) on NHWC."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _corr_to_channels(corr: torch.Tensor, im_size: int) -> torch.Tensor:
    """(B, h, w, s, s) compressed correlation -> (B, h, w, s*s) channels."""
    b, h, w = corr.shape[:3]
    return corr.reshape(b, h, w, im_size * im_size)


def _conv4d_stack() -> nn.Sequential:
    """CenterPivot(1 -> 16, stride (1, 1, 2, 2)) -> ReLU -> CenterPivot(16 -> 1)
    -> ReLU; each block runs on the 6D route (no ``flat_dims``)."""
    return nn.Sequential(CenterPivotConv4d(1, 16, (3,) * 4, stride=(1, 1, 2, 2)), nn.ReLU(),
                         CenterPivotConv4d(16, 1, (3,) * 4), nn.ReLU())


def _mlp_head(in_ch: int, out_ch: int, mid_dim: int) -> nn.Sequential:
    """1x1 conv -> ReLU -> 1x1 conv (``att.0``, ``att.2``)."""
    return nn.Sequential(nn.Conv2d(in_ch, mid_dim, 1), nn.ReLU(), nn.Conv2d(mid_dim, out_ch, 1))


def _mlp(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    return pointwise(seq[2], torch.relu(pointwise(seq[0], x)))


def _broadcast_map(m: torch.Tensor, b: int, h: int, w: int, im_size: int) -> torch.Tensor:
    """A per-episode map of im_size^2 values as channels at every query pixel."""
    return m.reshape(b, 1, 1, im_size * im_size).expand(b, h, w, im_size * im_size)


class DynamicFusion(nn.Module):
    def __init__(self, im_size: int = 30, mid_dim: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.im_size = im_size
        self.conv4d = CenterPivotConv4d(1, 1, (3,) * 4, stride=(1, 1, 2, 2))
        self.att = _mlp_head(2 * im_size * im_size, 1, mid_dim)
        init_conv_parameters(self, generator)

    def forward(self, corr: torch.Tensor, s_mask: torch.Tensor) -> torch.Tensor:
        """corr (B, h, w, hs, ws); s_mask (B, 2 im, 2 im, 1) -> (B, h, w, 1)."""
        b, h, w = corr.shape[:3]
        x = _corr_to_channels(self.conv4d(corr[..., None])[..., 0], self.im_size)
        sm = _broadcast_map(avg_pool_2x2(s_mask), b, h, w, self.im_size)
        return torch.sigmoid(_mlp(self.att, torch.cat([x, sm.to(x.dtype)], dim=-1)))


class FuseNet1(nn.Module):
    """Two correlations (the fuse head's filtered and bottleneck ones)
    through one shared stack, the support mask and prediction maps of
    ``pd_channels`` channels in all -> (B, h, w, 2) softmax weights. The
    MLP's input channels are, in order: each correlation's im_size^2, the
    mask's im_size^2, the prediction maps'."""

    def __init__(self, im_size: int = 30, mid_dim: int = 256, pd_channels: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.im_size = im_size
        self.conv4d = _conv4d_stack()
        self.att = _mlp_head(3 * im_size * im_size + pd_channels, 2, mid_dim)
        init_conv_parameters(self, generator)

    def forward(self, corr_lst: Sequence[torch.Tensor], s_mask: torch.Tensor,
                pd_lst: Sequence[torch.Tensor]) -> torch.Tensor:
        b, h, w = corr_lst[0].shape[:3]
        feats: List[torch.Tensor] = [
            _corr_to_channels(self.conv4d(corr[..., None])[..., 0], self.im_size)
            for corr in corr_lst]
        if s_mask.shape[1] == 2 * self.im_size:
            s_mask = avg_pool_2x2(s_mask)
        dtype = feats[0].dtype
        feats.append(_broadcast_map(s_mask, b, h, w, self.im_size).to(dtype))
        feats.extend(p.to(dtype) for p in pd_lst)
        return torch.softmax(_mlp(self.att, torch.cat(feats, dim=-1)), dim=-1)


class FuseNet(nn.Module):
    """One correlation through the stack, a prediction map of
    ``pd_channels`` channels, fg/bg correlation summaries and the support
    mask (im_size^2 values each) -> (B, h, w, 1) sigmoid weights."""

    def __init__(self, im_size: int = 30, mid_dim: int = 256, pd_channels: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.im_size = im_size
        self.conv4d = _conv4d_stack()
        self.att = _mlp_head(4 * im_size * im_size + pd_channels, 1, mid_dim)
        init_conv_parameters(self, generator)

    def forward(self, corr: torch.Tensor, pd_mask0: torch.Tensor, corr_fg: torch.Tensor,
                corr_bg: torch.Tensor, s_mask: torch.Tensor) -> torch.Tensor:
        b, h, w = corr.shape[:3]
        x = _corr_to_channels(self.conv4d(corr[..., None])[..., 0], self.im_size)
        feats = [x, pd_mask0.to(x.dtype)]
        feats += [_broadcast_map(m, b, h, w, self.im_size).to(x.dtype)
                  for m in (corr_fg, corr_bg, s_mask)]
        return torch.sigmoid(_mlp(self.att, torch.cat(feats, dim=-1)))
