"""Classifier Weight Transformer (PyTorch).

Counterpart of ``few_shot_seg_cwt_tpu.models.cwt.MultiHeadAttentionOne``: one
cross-attention block whose queries are the (K, 512) episodic classifier
weights and whose keys/values are the flattened (h*w, 512) query features.
Q, K and V share one bias-free projection ``w_qkvs``; attention is scaled by
sqrt(d_k) with dropout 0.1 on its weights; then ``fc`` (with bias), output
dropout, residual and LayerNorm (eps 1e-5). Both dropouts are live only in
training mode (the JAX ``deterministic=False``), and their masks come from
the ``torch.Generator`` the caller passes, never from torch's global one, so
a train step is reproducible from its generator's state.

Shapes are tiny (len_q = 2, len_k = 3600), so this is plain matmul and
softmax; it was no Pallas kernel in the JAX package either.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            mask_shape: Optional[Tuple[int, ...]] = None,
            shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - rate and
    scale the kept ones by 1/(1 - rate). ``mask_shape`` broadcasts one draw
    over axes of size 1 (channel dropout). The mask is drawn on the
    generator's device (the host for a CPU generator) and moved to ``x``'s.

    ``shard`` (rank, world): ``x``'s leading axis is this rank's slice of a
    global batch world times as long, so the mask of the global batch is
    drawn and this rank's rows kept; every rank's generator then advances
    alike and row i gets the mask it gets on one process."""
    if rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs a torch.Generator in training mode")
    shape = tuple(mask_shape or x.shape)
    rank, world = shard
    keep = torch.rand((shape[0] * world,) + shape[1:], generator=generator,
                      device=generator.device)[rank * shape[0]:(rank + 1) * shape[0]] >= rate
    return torch.where(keep.to(x.device), x / (1.0 - rate), torch.zeros_like(x))


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
        self.attn_dropout = attn_dropout
        self.dropout = dropout
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

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
        """q: (B, len_q, d_model); k, v: (B, h, w, d_model) or (B, L, d_model).
        In training mode the dropout masks are drawn from ``generator``
        (attention weights first, then the output), for the global batch
        of which B is rank ``shard[0]``'s slice (``dropout``)."""
        attn_rate, out_rate = (self.attn_dropout, self.dropout) if self.training else (0.0, 0.0)
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
        attn = dropout(torch.softmax(attn, dim=-1), attn_rate, generator, shard=shard)
        out = torch.matmul(attn, vp)
        out = out.transpose(1, 2).reshape(b, len_q, self.n_head * self.d_v)
        out = dropout(self.fc(out), out_rate, generator, shard=shard)
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
