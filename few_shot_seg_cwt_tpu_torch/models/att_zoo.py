"""The attention variants of the ``att`` head (PyTorch).

Counterpart of ``few_shot_seg_cwt_tpu.models.att_zoo`` (reference:
src/model/transformer.py:86-249), chosen by ``trans_type``
(``build_attention_variant``):

* ``CrossAttention`` (``cross_att``): masked multi-head cross-attention,
  optional layer norms of q and k (``ln``), value projection (``fv``) and
  output projection (``fc``), value normalisation (``trans_vn``), dropout
  on the attention and on the output, ``LayerNorm(out + idt)``;
* ``MHA`` (``mha``): the pre-norm variant (q, k and v normalised), output
  ``out + idt``;
* ``AttentionBlock`` (``att_blk``): cosine attention with a learnable scale
  (20 at init) and ``LinearDiag`` gates on the readout (0.2) and the
  identity (1.0).

Inputs are (B, N, C) token rows: k (B, N_s, C), v (B, N_s, Cv), q (B, N_q,
C), idt (B, N_q, Cv), and a (B, N_s) mask of support tokens to ignore, which
enters the attention logits as a -1000 bias (a soft mask, as in the
reference). Each module returns (output, attention). They are plain GEMMs
and softmaxes (``torch.matmul``), not ``scaled_dot_product_attention``:
the attention map is an output, and the bias is added where the JAX
package adds it. Parameter names are the reference's; a ``torch.Generator``
draws the JAX package's initialisers (U(+-1/sqrt(fan_in)) linear kernels,
xavier-normal for ``CrossAttention.fc``, identity plus N(0, 1e-3) noise for
``AttentionBlock.qk_fc``, zero biases). Dropout draws from torch's default
generator on the device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.corr import l2norm


def _linear(n_in: int, n_out: int, bias: bool, generator: Optional[torch.Generator],
            init: str = "fan_in") -> nn.Linear:
    """nn.Linear with the JAX initialiser: ``fan_in`` U(+-1/sqrt(fan_in))
    (variance scaling 1/3, uniform) or ``xavier`` normal; zero bias."""
    lin = nn.Linear(n_in, n_out, bias=bias)
    with torch.no_grad():
        if init == "xavier":
            nn.init.xavier_normal_(lin.weight, generator=generator)
        else:
            nn.init.kaiming_uniform_(lin.weight, a=math.sqrt(5), generator=generator)
        if bias:
            lin.bias.zero_()
    return lin


def _mask_bias(attn: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """-1000 where the mask is set, in the attention's dtype."""
    return mask.to(attn.dtype) * (-1000.0)


class CrossAttention(nn.Module):
    """``in_dim`` is the width of q and k (``dim`` by default), ``v_dim`` the
    width of v (``dim_v`` by default); idt must have the output's width."""

    def __init__(self, n_head: int = 4, dim: int = 512, dim_v: int = 512,
                 ln: Optional[str] = None, fv: Optional[str] = None, fc: Optional[str] = None,
                 dropout: float = 0.1, temp: Optional[float] = None, trans_vn: bool = False,
                 in_dim: Optional[int] = None, v_dim: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        in_dim = in_dim or dim
        v_dim = v_dim or dim_v
        self.n_head, self.dropout, self.trans_vn = n_head, dropout, trans_vn
        self.ln, self.fv, self.fc_on = ln == "ln", fv == "fv", fc == "fc"
        # the scale reads q's width, not dim (the reference's)
        self.temperature = temp if temp is not None else (in_dim // n_head) ** -0.5
        if self.ln:
            self.layer_norm_q = nn.LayerNorm(in_dim, eps=1e-5)
            self.layer_norm_k = nn.LayerNorm(in_dim, eps=1e-5)
        self.qk_fc = _linear(in_dim, dim, False, generator)
        if self.fv:
            self.v_fc = _linear(v_dim, dim_v, False, generator)
        out_dim = dim_v if self.fv else v_dim
        if self.fc_on:
            self.fc = _linear(out_dim, dim_v, True, generator, init="xavier")
            out_dim = dim_v
        self.layer_norm = nn.LayerNorm(out_dim, eps=1e-5)

    def forward(self, k, v, q, idt, s_valid_mask=None, deterministic: bool = True):
        b, n_q, _ = q.shape
        n_s = v.shape[1]
        h = self.n_head
        if self.trans_vn:
            v, idt = l2norm(v, dim=-1), l2norm(idt, dim=-1)
        if self.ln:
            q, k = self.layer_norm_q(q), self.layer_norm_k(k)
        qp = self.qk_fc(q).reshape(b, n_q, h, -1).transpose(1, 2)
        kp = self.qk_fc(k).reshape(b, n_s, h, -1).transpose(1, 2)
        if self.fv:
            v = self.v_fc(v)
        vp = v.reshape(b, n_s, h, -1).transpose(1, 2)
        attn = torch.matmul(qp, kp.transpose(-1, -2)) * self.temperature
        attn = attn.reshape(b * h, n_q, n_s)
        if s_valid_mask is not None:
            # repeated over heads, then (b * n_head, 1, n_s): the reference's order
            m = torch.repeat_interleave(s_valid_mask[:, None, :], h, dim=1)
            attn = attn + _mask_bias(attn, m.reshape(b * h, 1, n_s))
        attn = torch.softmax(attn, dim=-1)
        attn = F.dropout(attn, self.dropout, training=not deterministic)
        out = torch.matmul(attn, vp.reshape(b * h, n_s, -1))
        out = out.reshape(b, h, n_q, -1).transpose(1, 2).reshape(b, n_q, -1)
        if self.fc_on:
            out = self.fc(out)
        out = F.dropout(out, self.dropout, training=not deterministic)
        return self.layer_norm(out + idt), attn


class MHA(nn.Module):
    """Pre-norm multi-head cross-attention; ``in_dim`` and ``v_dim`` as in
    ``CrossAttention``. ``qk_fc`` and ``v_fc`` have no bias (``qkv_bias``),
    ``proj`` has one."""

    def __init__(self, n_head: int = 4, dim: int = 512, dim_v: int = 512, fv=True, fc=True,
                 qkv_bias: bool = False, proj_drop: float = 0.1, attn_drop: float = 0.1,
                 in_dim: Optional[int] = None, v_dim: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        in_dim = in_dim or dim
        v_dim = v_dim or dim_v
        self.n_head, self.proj_drop, self.attn_drop = n_head, proj_drop, attn_drop
        self.fv, self.fc_on = fv in (True, "fv"), fc in (True, "fc")
        self.scale = (in_dim // n_head) ** -0.5
        self.norm1_q = nn.LayerNorm(in_dim, eps=1e-5)
        self.norm1_k = nn.LayerNorm(in_dim, eps=1e-5)
        self.norm1_v = nn.LayerNorm(v_dim, eps=1e-5)
        self.qk_fc = _linear(in_dim, dim, qkv_bias, generator)
        if self.fv:
            self.v_fc = _linear(v_dim, dim_v, qkv_bias, generator)
        if self.fc_on:
            self.proj = _linear(dim_v if self.fv else v_dim, dim_v, True, generator)

    def forward(self, k, v, q, idt=None, s_valid_mask=None, deterministic: bool = True):
        q, k, v = self.norm1_q(q), self.norm1_k(k), self.norm1_v(v)
        b, n_q, _ = q.shape
        n_s = v.shape[1]
        h = self.n_head
        qp = self.qk_fc(q).reshape(b, n_q, h, -1).transpose(1, 2)
        kp = self.qk_fc(k).reshape(b, n_s, h, -1).transpose(1, 2)
        if self.fv:
            v = self.v_fc(v)
        vp = v.reshape(b, n_s, h, -1).transpose(1, 2)
        attn = torch.matmul(qp, kp.transpose(-1, -2)) * self.scale
        if s_valid_mask is not None:
            attn = attn + _mask_bias(attn, s_valid_mask[:, None, None, :])
        attn = torch.softmax(attn, dim=-1)
        attn = F.dropout(attn, self.attn_drop, training=not deterministic)
        out = torch.matmul(attn, vp).transpose(1, 2).reshape(b, n_q, -1)
        if self.fc_on:
            out = self.proj(out)
        out = F.dropout(out, self.proj_drop, training=not deterministic)
        return out + idt, attn


class LinearDiag(nn.Module):
    """x * weight (+ bias): ``mode "l"`` a scalar weight, ``"ld"`` one a
    feature; the weight starts at ``wt``."""

    def __init__(self, mode: str = "l", wt: float = 1.0, num_features: int = 512,
                 use_bias: bool = False):
        super().__init__()
        shape = () if mode == "l" else (num_features,)
        self.weight = nn.Parameter(torch.full(shape, float(wt)))
        self.bias = nn.Parameter(torch.zeros(num_features)) if use_bias else None

    def forward(self, x):
        out = x * self.weight
        return out + self.bias if self.bias is not None else out


def _eye_plus_noise_(lin: nn.Linear, generator: Optional[torch.Generator]) -> None:
    """The JAX ``_eye_plus_noise_init`` on a flax (in, out) kernel, carried to
    the (out, in) weight: eye(in, out) + N(0, 1) * 0.001, transposed."""
    n_out, n_in = lin.weight.shape
    with torch.no_grad():
        noise = torch.randn((n_in, n_out), generator=generator) * 0.001
        lin.weight.copy_((torch.eye(n_in, n_out) + noise).T)
        lin.bias.zero_()


class AttentionBlock(nn.Module):
    """Cosine attention of the l2-normalised ``qk_fc`` projections of q and
    k, times a learnable scale (``scale_att "sc"``, else a constant 20),
    read out over v and gated: ``att_wt(readout) + org_wt(idt)``."""

    def __init__(self, dim: int = 2048, dim_v: int = 512, v_norm=False, mode: str = "l",
                 scale_att: str = "sc", in_dim: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.v_norm = v_norm in (True, "vn")
        self.qk_fc = nn.Linear(in_dim or dim, dim, bias=True)
        _eye_plus_noise_(self.qk_fc, generator)
        self.learn_scale = scale_att == "sc"
        if self.learn_scale:
            self.scale_att = nn.Parameter(torch.tensor(20.0))
        self.att_wt = LinearDiag(mode, 0.2, dim_v)
        self.org_wt = LinearDiag(mode, 1.0, dim_v)

    def forward(self, k, v, q, idt, s_valid_mask=None, deterministic: bool = True):
        if self.v_norm:
            v, idt = l2norm(v, dim=-1), l2norm(idt, dim=-1)
        qp = l2norm(self.qk_fc(q), dim=-1)
        kp = l2norm(self.qk_fc(k), dim=-1)
        scale = self.scale_att if self.learn_scale else 20.0
        attn = scale * torch.matmul(qp, kp.transpose(-1, -2))
        if s_valid_mask is not None:
            attn = attn + _mask_bias(attn, s_valid_mask[:, None, :])
        attn = torch.softmax(attn, dim=-1)
        fq_att = torch.matmul(attn, v)
        return self.att_wt(fq_att) + self.org_wt(idt), attn


def build_attention_variant(cfg, in_dim: int, generator: Optional[torch.Generator] = None):
    """The ``trans_type`` variant (reference: src/train_att.py:100-106) over a
    tap of ``in_dim`` channels and the ``bottleneck_dim`` features."""
    t = cfg.get("trans_type", "cross_att")
    d = int(cfg.bottleneck_dim)
    dim = int(cfg.backbone_dim)
    if t == "cross_att":
        return CrossAttention(n_head=int(cfg.heads), dim=dim, dim_v=d, ln=cfg.get("ln"),
                              fv=cfg.get("fv"), fc=cfg.get("fc"), temp=cfg.get("att_temp"),
                              trans_vn=cfg.get("trans_vn", False), in_dim=in_dim, v_dim=d,
                              generator=generator)
    if t == "mha":
        return MHA(n_head=int(cfg.heads), dim=dim, dim_v=d, in_dim=in_dim, v_dim=d,
                   generator=generator)
    if t == "att_blk":
        return AttentionBlock(dim=dim, dim_v=d, v_norm=cfg.get("trans_vn", False),
                              mode=cfg.get("ld_mode", "l"),
                              scale_att=cfg.get("scale_att", "sc"), in_dim=in_dim,
                              generator=generator)
    raise ValueError(f"unknown trans_type {t}")
