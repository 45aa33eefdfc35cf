"""Multi-scale deformable attention and the positional encodings (PyTorch).

Counterpart of ``few_shot_seg_cwt_tpu.models.deform``: ``MSDeformAttn``
(reference: src/model/ops/modules/ms_deform_attn.py:30-117, whose live
compute path is the pure-torch ``ms_deform_attn_core_pytorch`` on
F.grid_sample), ``SinePositionalEncoding`` and
``LearnedPositionalEncoding`` (src/model/positional_encoding.py) and the
DeTr self-attention branch ``DeformAtt`` (src/model/detr.py:78-151).

The bilinear sampling is ``F.grid_sample`` (zeros padding,
``align_corners=False``): the JAX package computes it as a gather outside
any Pallas kernel. Tensors are NHWC; the Linear layers keep the flax names
(``value_proj``, ``sampling_offsets``, ``attention_weights``,
``output_proj``) and the JAX initialisers, drawn from a generator.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def grid_sample_bilinear(value: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """F.grid_sample(mode=bilinear, padding=zeros, align_corners=False) on
    NHWC: value (N, H, W, C), grid (N, ..., 2) xy in [-1, 1] -> (N, ..., C)."""
    n, c = value.shape[0], value.shape[-1]
    lead = grid.shape[1:-1]
    g = grid.reshape(n, -1, 1, 2).to(value.dtype)
    out = F.grid_sample(value.permute(0, 3, 1, 2), g, mode="bilinear",
                        padding_mode="zeros", align_corners=False)      # (N, C, L, 1)
    return out[..., 0].permute(0, 2, 1).reshape((n,) + tuple(lead) + (c,))


def sine_positional_encoding(mask: torch.Tensor, num_feats: int,
                             temperature: float = 10000.0, normalize: bool = True,
                             scale: float = 2 * math.pi, eps: float = 1e-6) -> torch.Tensor:
    """mask (B, h, w), nonzero = ignored -> (B, h, w, 2 * num_feats) NHWC."""
    not_mask = (mask == 0).float()
    y_embed = torch.cumsum(not_mask, dim=1)
    x_embed = torch.cumsum(not_mask, dim=2)
    if normalize:
        y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    dim_t = np.arange(num_feats, dtype=np.float32)
    dim_t = torch.as_tensor(temperature ** (2 * (dim_t // 2) / num_feats), device=mask.device)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    pos_x = torch.stack([torch.sin(pos_x[..., 0::2]), torch.cos(pos_x[..., 1::2])], dim=4)
    pos_y = torch.stack([torch.sin(pos_y[..., 0::2]), torch.cos(pos_y[..., 1::2])], dim=4)
    return torch.cat([pos_y.flatten(3), pos_x.flatten(3)], dim=-1)


class LearnedPositionalEncoding(nn.Module):
    """Row and column embedding tables (U(0, 1) init); the output holds
    [col_embed(x), row_embed(y)] per position, (B, h, w, 2 * num_feats).
    Unused by any trainer; kept beside the sine encoding, as in JAX."""

    def __init__(self, num_feats: int, row_num_embed: int = 50, col_num_embed: int = 50,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_feats = num_feats
        self.row_embed = nn.Parameter(torch.rand(row_num_embed, num_feats, generator=generator))
        self.col_embed = nn.Parameter(torch.rand(col_num_embed, num_feats, generator=generator))

    def forward(self, mask: torch.Tensor) -> torch.Tensor:
        h, w = mask.shape[-2:]
        f = self.num_feats
        pos = torch.cat([self.col_embed[:w][None, :, :].expand(h, w, f),
                         self.row_embed[:h][:, None, :].expand(h, w, f)], dim=-1)
        return pos[None].expand(mask.shape[0], h, w, 2 * f)


def offset_bias_grid(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """The reference's sampling-offset bias: per-head unit directions scaled
    by the point index, flattened (heads, levels, points, 2)."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid.reshape(n_heads, 1, 1, 2), (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


def _linear(d_in: int, d_out: int, xavier: bool, generator) -> nn.Linear:
    lin = nn.Linear(d_in, d_out)
    with torch.no_grad():
        if xavier:
            nn.init.xavier_uniform_(lin.weight, generator=generator)
        else:
            lin.weight.zero_()
        lin.bias.zero_()
    return lin


class MSDeformAttn(nn.Module):
    def __init__(self, d_model: int = 256, n_levels: int = 1, n_heads: int = 8,
                 n_points: int = 4, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        m, l, p = n_heads, n_levels, n_points
        self.value_proj = _linear(d_model, d_model, True, generator)
        self.sampling_offsets = _linear(d_model, m * l * p * 2, False, generator)
        with torch.no_grad():
            self.sampling_offsets.bias.copy_(torch.from_numpy(offset_bias_grid(m, l, p)))
        self.attention_weights = _linear(d_model, m * l * p, False, generator)
        self.output_proj = _linear(d_model, d_model, True, generator)

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                input_flatten: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                input_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """query (N, Lq, C); reference_points (N, Lq, L, 2) in [0, 1];
        input_flatten (N, Lin, C); spatial_shapes [(H, W), ...] per level."""
        n, len_q, _ = query.shape
        m, l, p = self.n_heads, self.n_levels, self.n_points
        d = self.d_model // m
        value = self.value_proj(input_flatten)
        if input_padding_mask is not None:
            value = torch.where(input_padding_mask[..., None], torch.zeros_like(value), value)
        value = value.reshape(n, -1, m, d)
        offsets = self.sampling_offsets(query).reshape(n, len_q, m, l, p, 2)
        attn = self.attention_weights(query).reshape(n, len_q, m, l * p)
        attn = torch.softmax(attn, dim=-1).reshape(n, len_q, m, l, p)
        normalizer = torch.tensor([[w_, h_] for h_, w_ in spatial_shapes],
                                  dtype=torch.float32, device=query.device)
        loc = (reference_points[:, :, None, :, None, :]
               + offsets / normalizer[None, None, None, :, None, :])
        start = 0
        sampled = []
        for lid, (h_, w_) in enumerate(spatial_shapes):
            v = value[:, start:start + h_ * w_]
            start += h_ * w_
            v = v.permute(0, 2, 1, 3).reshape(n * m, h_, w_, d)
            g = (2.0 * loc[:, :, :, lid] - 1.0).permute(0, 2, 1, 3, 4).reshape(
                n * m, len_q, p, 2)
            sampled.append(grid_sample_bilinear(v, g))                   # (N*M, Lq, P, D)
        sampled = torch.stack(sampled, dim=2).reshape(n * m, len_q, l * p, d)
        aw = attn.permute(0, 2, 1, 3, 4).reshape(n * m, len_q, l * p)
        out = torch.einsum("qlkd,qlk->qld", sampled, aw)
        out = out.reshape(n, m, len_q, d).permute(0, 2, 1, 3).reshape(n, len_q, m * d)
        return self.output_proj(out)


class DeformAtt(nn.Module):
    """DeTr's self-attention branch: one level, queries ``fq_fea`` plus the
    sine position code, values ``f_q``, each query's reference point its
    own pixel centre. ``level_embed`` is kept for checkpoint parity; it
    takes part only with more than one level."""

    def __init__(self, embed_dims: int = 512, n_heads: int = 8, n_points: int = 9,
                 n_levels: int = 1, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed_dims = embed_dims
        self.level_embed = nn.Parameter(torch.rand(n_levels, embed_dims, generator=generator))
        self.self_trans = MSDeformAttn(embed_dims, n_levels, n_heads, n_points, generator)

    def forward(self, fq_fea: torch.Tensor, f_q: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, h, w, c = fq_fea.shape
        mask = (torch.zeros((b, h, w), dtype=torch.int32, device=fq_fea.device)
                if padding_mask is None else padding_mask)
        pos = sine_positional_encoding(mask, self.embed_dims // 2)
        q_flat = fq_fea.reshape(b, h * w, c) + pos.reshape(b, h * w, self.embed_dims)
        ref_y, ref_x = np.meshgrid((np.arange(h, dtype=np.float32) + 0.5) / h,
                                   (np.arange(w, dtype=np.float32) + 0.5) / w, indexing="ij")
        ref = torch.as_tensor(np.stack([ref_x.reshape(-1), ref_y.reshape(-1)], -1),
                              device=fq_fea.device)
        ref = ref[None, :, None, :].expand(b, h * w, 1, 2)
        # the padding mask feeds the position code only: the reference
        # passes input_padding_mask=None (detr.py:94)
        out = self.self_trans(q_flat, ref, f_q.reshape(b, h * w, -1), [(h, w)], None)
        return out.reshape(b, h, w, self.embed_dims)
