"""Classifier Weight Transformer (PyTorch).

Counterpart of ``few_shot_seg_cwt_tpu.models.cwt.MultiHeadAttentionOne``: one
cross-attention block whose queries are the (K, 512) episodic classifier
weights and whose keys/values are the flattened (h*w, 512) query features.
Q, K and V share one bias-free projection ``w_qkvs``; attention is scaled by
sqrt(d_k) with dropout 0.1 on its weights; then ``fc`` (with bias), output
dropout, residual and LayerNorm (eps 1e-5). Both dropouts are off in eval.

Shapes are tiny (len_q = 2, len_k = 3600), so this is plain matmul and
softmax; it was no Pallas kernel in the JAX package either.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn


class MultiHeadAttentionOne(nn.Module):
    """Shared-projection multi-head cross-attention over a feature map."""

    def __init__(self, n_head: int = 1, d_model: int = 512, d_k: int = 512,
                 d_v: int = 512, dropout: float = 0.5,
                 attn_dropout: float = 0.1):
        super().__init__()
        if d_k != d_v:
            raise ValueError("one shared projection needs d_k == d_v")
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.w_qkvs = nn.Linear(d_model, n_head * d_k, bias=False)
        self.fc = nn.Linear(n_head * d_v, d_model)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-5)
        self.attn_dropout = nn.Dropout(attn_dropout)
        self.dropout = nn.Dropout(dropout)
        self.temperature = math.sqrt(d_k)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init: normal(0, sqrt(2/(d_model+d_k))) for w_qkvs,
        xavier-normal fc weight, torch-default fc bias, unit LayerNorm."""
        d_model = self.w_qkvs.in_features
        nn.init.normal_(self.w_qkvs.weight, 0.0,
                        math.sqrt(2.0 / (d_model + self.d_k)), generator=generator)
        nn.init.xavier_normal_(self.fc.weight, generator=generator)
        bound = 1.0 / math.sqrt(self.fc.in_features)
        nn.init.uniform_(self.fc.bias, -bound, bound, generator=generator)
        self.layer_norm.reset_parameters()

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        """q: (B, len_q, d_model); k, v: (B, h, w, d_model) or (B, L, d_model)."""
        if k.ndim == 4:
            k = k.reshape(k.shape[0], -1, k.shape[-1])
        if v.ndim == 4:
            v = v.reshape(v.shape[0], -1, v.shape[-1])
        b, len_q, _ = q.shape
        residual = q
        # (B, L, n_head, d_k) -> (B, n_head, L, d_k)
        qp = self.w_qkvs(q).view(b, len_q, self.n_head, self.d_k).transpose(1, 2)
        kp = self.w_qkvs(k).view(b, k.shape[1], self.n_head, self.d_k).transpose(1, 2)
        vp = self.w_qkvs(v).view(b, v.shape[1], self.n_head, self.d_v).transpose(1, 2)
        attn = torch.matmul(qp, kp.transpose(-1, -2)) / self.temperature
        attn = self.attn_dropout(torch.softmax(attn, dim=-1))
        out = torch.matmul(attn, vp)
        out = out.transpose(1, 2).reshape(b, len_q, self.n_head * self.d_v)
        out = self.dropout(self.fc(out))
        return self.layer_norm(out + residual)


def build_cwt(cfg, generator: Optional[torch.Generator] = None) -> MultiHeadAttentionOne:
    """CWT transformer from config, with a seeded random init."""
    d = cfg.bottleneck_dim
    model = MultiHeadAttentionOne(n_head=cfg.heads, d_model=d, d_k=d, d_v=d,
                                  dropout=0.5)
    if generator is None:
        generator = torch.Generator().manual_seed(int(cfg.get("manual_seed") or 0) + 1)
    model.reset_parameters(generator)
    return model
