"""Correlation-volume primitives (cosine correlation, mutual matching).

Counterpart of ``few_shot_seg_cwt_tpu.ops.corr`` (reference:
src/model/model_util.py:101-109 and src/model/match.py:21-53). Flattened
correlations are (B, N_q, N_s); volumes are flat channels-major
(B, C, Q, S) or rank-4 channels-last (B, Q, S, C). The 6D ``mutual_matching``
and ``mutual_nn_filter`` are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch


def l2norm(x: torch.Tensor, dim: int, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize: x / max(||x||, eps) along ``dim``."""
    n = torch.sqrt(torch.sum(x.float() ** 2, dim=dim, keepdim=True))
    return (x / torch.clamp(n, min=eps)).to(x.dtype)


def get_corr(q_feat: torch.Tensor, k_feat: torch.Tensor) -> torch.Tensor:
    """Cosine correlation of two NHWC feature maps -> (B, Nq, Nk), fp32."""
    b, h, w, c = q_feat.shape
    q = l2norm(q_feat.reshape(b, h * w, c), dim=-1)
    k = l2norm(k_feat.reshape(b, -1, c), dim=-1)
    return torch.bmm(q.float(), k.float().transpose(1, 2))


def _mutual(corr: torch.Tensor, q_dim: int, s_dim: int, eps: float) -> torch.Tensor:
    max_s = torch.amax(corr, dim=s_dim, keepdim=True)   # over support pixels
    max_q = torch.amax(corr, dim=q_dim, keepdim=True)   # over query pixels
    return corr * ((corr / (max_s + eps)) * (corr / (max_q + eps)))


def mutual_matching_flat(corr: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-channel mutual-max normalisation of a (B, C, Q, S) volume."""
    return _mutual(corr, 2, 3, eps)


def mutual_matching_bqsc(corr: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-channel mutual-max normalisation of a (B, Q, S, C) volume."""
    return _mutual(corr, 1, 2, eps)


def masked_attention_readout(
    corr2d: torch.Tensor,                  # (B, N_q, N_s)
    values: torch.Tensor,                  # (B, N_s, C) or NHWC support features
    temp: float = 20.0,
    ig_mask: Optional[torch.Tensor] = None,  # (B, N_s) bool, True = ignore
    ig_fill: float = 1e-4,
) -> torch.Tensor:
    """softmax(corr * temp) @ values, with ignored support pixels overwritten
    by a small constant (not -inf) before the softmax, as the reference does."""
    if values.ndim == 4:
        b, h, w, c = values.shape
        values = values.reshape(b, h * w, c)
    if ig_mask is not None:
        corr2d = torch.where(ig_mask[:, None, :], torch.full_like(corr2d, ig_fill), corr2d)
    attn = torch.softmax(corr2d.float() * temp, dim=-1)
    return torch.bmm(attn, values.float())
