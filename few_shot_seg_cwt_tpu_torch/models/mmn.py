"""MMN: multi-layer matching network (PyTorch).

Counterpart of ``few_shot_seg_cwt_tpu.models.mmn`` (reference:
src/model/mmn.py:11-88): a cosine correlation per selected backbone block
(``rmid`` picks stages; ``all_lr`` decides whether every bottleneck block of
a stage contributes or only its last), each feature optionally reduced
(``rd_<stage>``, ``red_dim``) and smoothed (``wa_<stage>``, ``WeightAverage``)
first; the correlations are stacked as channels (``agg cat``) or summed
(``agg sum``), filtered by MatchNet's neighbourhood consensus, read out over
the support feature, and blended into the query feature:
fq = f_q * (1 - att_wt) + att_fq * att_wt.

The volume is built in the layout of the active consensus route: rank-4
(shot, Q, S, L) by default, channels-major (shot, L, Q, S) for the flat
pivot-kernel route. Parameter names are the reference's, so
``utils.ckpt.import_mmn`` of the JAX package reads ``state_dict()``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn

from ..ops.corr import get_corr
from .conv4d import init_conv_parameters
from .matching import MatchNet, block_remat_default, ncons_r4_active
from .msm import WeightAverage, pointwise
from .resnet import RESNET_DEPTHS

FEATURE_CHANNELS = (256, 512, 1024, 2048)


def parse_bids(rmid: str) -> List[int]:
    """'l34' -> [3, 4] (reference: src/model/mmn.py:18)."""
    return [int(ch) for ch in rmid[1:]]


class MMN(nn.Module):
    """Multi-layer matching over backbone block features (NHWC)."""

    def __init__(self, bids: Sequence[int] = (3, 4), all_lr: str = "l",
                 nbottlenecks: Sequence[int] = (3, 4, 6, 3), agg: str = "cat",
                 wa: bool = False, red_dim: int = 0, temp: float = 3.0,
                 cv_type: str = "red", att_wt: float = 0.5, att_drop: float = 0.0,
                 proj_drop: float = 0.0,
                 feature_channels: Sequence[int] = FEATURE_CHANNELS,
                 block_remat: bool = True):
        super().__init__()
        if agg not in ("cat", "sum"):
            raise ValueError(f"agg {agg!r}: 'cat' or 'sum'")
        self.bids, self.all_lr, self.agg = tuple(bids), str(all_lr), agg
        self.wa, self.red_dim = wa, int(red_dim or 0)
        self.cv_type, self.att_wt = cv_type, att_wt
        for bid in self.bids:
            ch = feature_channels[bid - 1]
            if self.red_dim:
                setattr(self, f"rd_{bid}", nn.Sequential(
                    nn.Conv2d(ch, self.red_dim, 1, bias=False), nn.ReLU()))
                ch = self.red_dim
            if wa:
                setattr(self, f"wa_{bid}", WeightAverage(ch, att_drop=att_drop,
                                                         proj_drop=proj_drop))
        in_ch = 1 if agg == "sum" else sum(
            nbottlenecks[b - 1] if str(b) in self.all_lr else 1 for b in self.bids)
        self.corr_net = MatchNet(temp=temp, cv_type=cv_type, in_channel=in_ch,
                                 block_remat=block_remat)

    def _selected(self, feats: Dict) -> List:
        """(stage, feature) pairs per rmid/all_lr selection, stages reversed."""
        out = []
        for bid in self.bids[::-1]:
            blocks = feats[bid]
            chosen = blocks if str(bid) in self.all_lr else [blocks[-1]]
            out.extend((bid, f) for f in chosen)
        return out

    def _prep(self, bid: int, fea: torch.Tensor, deterministic: bool) -> torch.Tensor:
        if self.red_dim:
            fea = torch.relu(pointwise(getattr(self, f"rd_{bid}")[0], fea))
        if self.wa:
            fea = getattr(self, f"wa_{bid}")(fea, deterministic=deterministic)
        return fea

    def prep_query(self, fq_feats: Dict, deterministic: bool = True) -> List:
        """Query-side per-layer prep (rd conv + WeightAverage), shot-free."""
        return [self._prep(bid, f, deterministic) for bid, f in self._selected(fq_feats)]

    def forward(self, fq_feats: Dict, fs_feats: Dict, f_q: torch.Tensor,
                f_s: torch.Tensor, ret_attn: bool = False, ret_shots: bool = False,
                deterministic: bool = True, fq_prepped: Optional[List] = None):
        """fq_feats {stage: [(1, h', w', C)]}, fs_feats {stage: [(shot, h', w',
        C)]}, f_q (1, h, w, 512), f_s (shot, h, w, 512). Returns (fq, att_fq);
        with ``ret_shots`` also the per-shot readouts (shot, h, w, 512)."""
        shot, h, w, _ = f_s.shape
        corr_ch = []
        for i, ((bid, fq_fea), (_, fs_fea)) in enumerate(zip(
                self._selected(fq_feats), self._selected(fs_feats))):
            if fq_prepped is not None:
                fq_fea = fq_prepped[i].expand((shot,) + fq_prepped[i].shape[1:])
            else:
                fq_fea = self._prep(bid, fq_fea.expand((shot,) + fq_fea.shape[1:]),
                                    deterministic)
            fs_fea = self._prep(bid, fs_fea, deterministic)
            corr_ch.append(get_corr(fq_fea, fs_fea))            # (shot, Nq, Ns)

        dims = (h, w, h, w)
        if ncons_r4_active(self.cv_type):
            corr = torch.stack(corr_ch, dim=-1)
            if self.agg == "sum":
                corr = corr.sum(dim=-1, keepdim=True)
            attn, att_shots = self.corr_net.corr_forward_bqsc(corr, f_s, dims, ret_attn=True)
        else:
            corr = torch.stack(corr_ch, dim=1)
            if self.agg == "sum":
                corr = corr.sum(dim=1, keepdim=True)
            attn, att_shots = self.corr_net.corr_forward_flat(corr, f_s, dims, ret_attn=True)
        att_fq = att_shots.mean(dim=0, keepdim=True)
        fq = f_q * (1.0 - self.att_wt) + att_fq * self.att_wt
        if ret_shots:
            return fq, att_fq, att_shots
        if ret_attn:
            return attn, fq, att_fq
        return fq, att_fq


def build_mmn(cfg, generator: Optional[torch.Generator] = None) -> MMN:
    """MMN from a flat config, with a seeded init (U(+-1/sqrt(fan_in))
    kernels, zero biases, as the JAX package initialises it)."""
    if not cfg.get("rmid"):
        raise ValueError("MMN needs the rmid config (which backbone stages to "
                         "correlate), e.g. --opts rmid 'l34'")
    model = MMN(
        bids=tuple(parse_bids(cfg.rmid)),
        all_lr=str(cfg.all_lr),
        nbottlenecks=tuple(RESNET_DEPTHS[cfg.layers]),
        agg=cfg.get("agg", "cat"),
        wa=bool(cfg.get("wa", False)),
        red_dim=int(cfg.get("red_dim") or 0),
        temp=cfg.temp,
        cv_type=cfg.get("conv4d", "red"),
        att_wt=cfg.att_wt,
        att_drop=float(cfg.get("att_drop", 0.0)),
        proj_drop=float(cfg.get("proj_drop", 0.0)),
        block_remat=block_remat_default(cfg, cfg.get("conv4d", "red")),
    )
    if generator is None:
        generator = torch.Generator().manual_seed(int(cfg.get("manual_seed") or 0) + 1)
    init_conv_parameters(model, generator)
    return model
