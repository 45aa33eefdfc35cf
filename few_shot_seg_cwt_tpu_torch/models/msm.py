"""Multi-scale and neighbourhood feature blocks (PyTorch).

Counterpart of ``few_shot_seg_cwt_tpu.models.msm`` (reference:
src/model/msm/msm_func.py):

* ``MSBlock`` (src:12-47): a 3x3 conv then three dilated 3x3 convs (rates
  r, 2r, 3r), their ReLU'd outputs summed, convs initialised N(0, 0.01)
  with zero biases;
* ``WeightAverage`` (src:50-104): 3x3-neighbourhood cosine attention with a
  residual. The 1x1 projections commute with spatial shifts, so the nine
  neighbour views are replicate-padded shifts of the projected maps (no
  unfold).

Features are NHWC; the convs keep the reference's names (``conv``,
``conv1``-``conv3``; ``conv_theta``, ``conv_phi``, ``conv_g``,
``conv_back``).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def pointwise(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 ``nn.Conv2d`` applied to NHWC features."""
    return F.linear(x, conv.weight[:, :, 0, 0], conv.bias)


class MSBlock(nn.Module):
    """(B, h, w, c_in) -> (B, h, w, c_out): o + o1 + o2 + o3 with o the
    ReLU'd 3x3 conv and o_k the ReLU'd 3x3 conv of o at dilation k * rate."""

    def __init__(self, c_in: int, c_out: int = 32, rate: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        r = max(rate, 1)
        self.conv = nn.Conv2d(c_in, c_out, 3, padding=1)
        for k in (1, 2, 3):
            setattr(self, f"conv{k}", nn.Conv2d(c_out, c_out, 3, padding=r * k,
                                                dilation=r * k))
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.normal_(m.weight, 0.0, 0.01, generator=generator)
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        o = torch.relu(self.conv(x.permute(0, 3, 1, 2)))
        out = o + sum(torch.relu(getattr(self, f"conv{k}")(o)) for k in (1, 2, 3))
        return out.permute(0, 2, 3, 1)


def _neighbor_shifts(x: torch.Tensor, r: int = 3) -> List[torch.Tensor]:
    """Replicate-padded shifted views of (B, h, w, C), row-major r*r."""
    pad = r // 2
    h, w = x.shape[1], x.shape[2]
    rows = torch.arange(-pad, h + pad, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-pad, w + pad, device=x.device).clamp(0, w - 1)
    xp = x[:, rows][:, :, cols]
    return [xp[:, di:di + h, dj:dj + w] for di in range(r) for dj in range(r)]


class WeightAverage(nn.Module):
    """Local cosine-attention smoothing with residual, (B, h, w, C) -> same."""

    def __init__(self, channels: int, r: int = 3, att_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        c_out = channels // 2
        self.r, self.att_drop, self.proj_drop = r, att_drop, proj_drop
        self.conv_theta = nn.Conv2d(channels, c_out, 1)
        self.conv_phi = nn.Conv2d(channels, c_out, 1)
        self.conv_g = nn.Conv2d(channels, c_out, 1)
        self.conv_back = nn.Conv2d(c_out, channels, 1)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        theta = pointwise(self.conv_theta, x)                       # centre pixel
        phis = torch.stack(_neighbor_shifts(pointwise(self.conv_phi, x), self.r), dim=3)
        gs = torch.stack(_neighbor_shifts(pointwise(self.conv_g, x), self.r), dim=3)
        dot = torch.einsum("bhwkc,bhwc->bhwk", phis, theta)
        # cosine similarity with torch's eps=1e-8 clamp on the norm product
        denom = torch.clamp(torch.linalg.norm(phis, dim=-1)
                            * torch.linalg.norm(theta, dim=-1)[..., None], min=1e-8)
        attn = torch.softmax(dot / denom, dim=-1)
        attn = F.dropout(attn, self.att_drop, training=not deterministic)
        avg = torch.einsum("bhwk,bhwkc->bhwc", attn, gs)
        res = F.dropout(pointwise(self.conv_back, avg), self.proj_drop,
                        training=not deterministic)
        return x + res
