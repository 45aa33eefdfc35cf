"""DeTr head: cross-attention matching and deformable self-attention (PyTorch).

Counterpart of ``few_shot_seg_cwt_tpu.models.detr`` (reference:
src/model/detr.py:13-75): concatenate the selected mid-level backbone taps
(``l34`` -> layer3 and layer4), reduce them to ``reduce_dim`` with a 1x1
conv and a ReLU (``adjust``; channel dropout under ``drop``), then blend the
MatchNet cross-attention readout (``cross_trans``, a centre-pivot
``MatchNet`` with one correlation channel) and/or the deformable
self-attention readout (``self_trans``) into the L2-normalised query
feature with weight ``att_wt``.

The reference indexes its feature container with stale list positions
(detr.py:52-57 against the dict of pspnet.py:272-287); as in the JAX
package, the taps read here are the intended ones: the last block of each
selected stage.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ..ops.corr import l2norm
from .conv4d import init_conv_parameters
from .deform import DeformAtt
from .matching import MatchNet, block_remat_default
from .msm import pointwise

IN_DIM_LOOKUP = {"l2": 512, "l3": 1024, "l4": 2048, "l34": 1024 + 2048, "l23": 512 + 1024}


def detr_stages(rmid: str):
    """'l34' -> [3, 4]: the stages whose last blocks DeTr reads."""
    return [int(c) for c in str(rmid)[1:]]


class DeTr(nn.Module):
    def __init__(self, rmid: str = "l34", reduce_dim: int = 512, sf_att: bool = False,
                 cs_att: bool = True, temp: float = 20.0, att_wt: float = 0.5,
                 drop: bool = False, block_remat: bool = True,
                 in_dim: Optional[int] = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rmid, self.reduce_dim = rmid, reduce_dim
        self.sf_att, self.cs_att = sf_att, cs_att
        self.att_wt, self.drop = att_wt, drop
        self.adjust = nn.Conv2d(in_dim or IN_DIM_LOOKUP[rmid], reduce_dim, 1, bias=False)
        if cs_att:
            self.cross_trans = MatchNet(temp=temp, cv_type="red", sce=False, sym_mode=True,
                                        in_channel=1, block_remat=block_remat)
        init_conv_parameters(self, generator)
        if sf_att:
            self.self_trans = DeformAtt(embed_dims=reduce_dim, n_heads=8, n_points=9,
                                        n_levels=1, generator=generator)

    def adjust_feature(self, x: torch.Tensor, deterministic: bool) -> torch.Tensor:
        x = torch.relu(pointwise(self.adjust, x))
        if self.drop and not deterministic:
            # flax Dropout(0.5, broadcast_dims=(-3, -2)): one draw a channel,
            # shared over h and w; from torch's default generator
            keep = torch.rand((x.shape[0], 1, 1, x.shape[-1]), device=x.device) < 0.5
            x = torch.where(keep, x / 0.5, torch.zeros_like(x))
        return x

    def compute_feat(self, fq_feats: Dict, fs_feats: Dict, deterministic: bool):
        stages = detr_stages(self.rmid)
        fq = torch.cat([fq_feats[s][-1] for s in stages], dim=-1)
        fs = torch.cat([fs_feats[s][-1] for s in stages], dim=-1)
        return self.adjust_feature(fq, deterministic), self.adjust_feature(fs, deterministic)

    def forward(self, fq_feats: Dict, fs_feats: Dict, f_q: torch.Tensor, f_s: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None, deterministic: bool = True):
        """fq_feats / fs_feats {stage: [(B, h, w, C_stage)]}; f_q, f_s (B, h,
        w, C) query and support features. Returns (blended f_q, the
        self-attention readout or None, the cross-attention readout or
        None)."""
        fq_fea, fs_fea = self.compute_feat(fq_feats, fs_feats, deterministic)
        sa_fq = ca_fq = None
        if self.cs_att:
            ca_fq = self.cross_trans(fq_fea, fs_fea, f_s)
            f_q = l2norm(f_q, dim=-1) + l2norm(ca_fq, dim=-1) * self.att_wt
        if self.sf_att:
            sa_fq = self.self_trans(fq_fea, f_q, padding_mask=padding_mask)
            f_q = l2norm(f_q, dim=-1) + l2norm(sa_fq, dim=-1) * self.att_wt
        return f_q, sa_fq, ca_fq


def build_detr(cfg, generator: Optional[torch.Generator] = None,
               in_dim: Optional[int] = None) -> DeTr:
    """DeTr with the JAX ``build_detr`` arguments and a seeded init (the
    ``adjust`` conv and the consensus U(+-1/sqrt(fan_in)), zero consensus
    biases; the deformable attention's xavier / zero / grid inits)."""
    if generator is None:
        generator = torch.Generator().manual_seed(int(cfg.get("manual_seed") or 0) + 1)
    return DeTr(rmid=cfg.rmid, reduce_dim=cfg.get("reduce_dim", 512),
                sf_att=bool(cfg.get("sf_att", False)),
                cs_att=bool(cfg.get("cr_att", cfg.get("cs_att", True))),
                temp=cfg.temp, att_wt=cfg.att_wt, drop=bool(cfg.get("drop", False)),
                block_remat=block_remat_default(cfg, "red"), in_dim=in_dim,
                generator=generator)
