"""Episode-level mask utilities: the ignore mask, the readouts.

Counterpart of part of ``few_shot_seg_cwt_tpu.ops.episode_utils``
(reference: src/model/model_util.py:178-236, src/model/pspnet.py:224-256):

* ``masked_quantile``: ``torch.quantile`` over the masked entries, linear
  interpolation, by a sort of the whole vector with masked-out entries
  pushed to the end;
* ``get_ig_mask`` (src:178-221): the support pixels to ignore, from
  quantile-thresholded query-FG/BG similarity statistics crossed with the
  support prediction;
* ``att_weighted_out`` (src:224-236): the softmax readout with ignored
  entries set to 1e-5 (MatchNet's own readout uses 1e-4, as the
  reference's two sites do);
* ``outer_forward`` (src/model/pspnet.py:224-256): the transductive
  softmax blend of the ``asy`` head, ``(weighted_v * gamma + f_q) / (1 +
  gamma)``;
* the incremental (CCA) trainers' helpers (src/model/model_util.py:112-166):
  ``reset_cls_wt`` (base rows from the stage-1 classifier, the novel row
  re-seeded), ``reset_spt_label`` (support BG pseudo-labelled by the base
  classifier), ``adapt_reset_spt_label_np`` (the host pass of the adaptive
  trainer, with the reference's relabel inside its frequency loop),
  ``compress_pred`` (K-way to binary probabilities) and ``pred2bmask``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from .corr import get_corr, l2norm
from .resize import resize_nearest


def masked_quantile(values: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """torch.quantile(values[mask], q), linear interpolation; flat inputs.
    With no entry selected it reads the sentinel, as the JAX version does."""
    big = torch.finfo(torch.float32).max
    v = torch.where(mask, values.float(), torch.full_like(values, big, dtype=torch.float32))
    v = torch.sort(v).values
    n = mask.sum().float()
    pos = q * (n - 1.0)
    lo, hi = torch.floor(pos).long(), torch.ceil(pos).long()
    frac = pos - lo.float()
    last = v.shape[0] - 1
    v_lo, v_hi = v[lo.clamp(0, last)], v[hi.clamp(0, last)]
    return v_lo + frac * (v_hi - v_lo)


def get_ig_mask(sim: torch.Tensor, s_label: torch.Tensor, q_label: torch.Tensor,
                pd_q0: torch.Tensor, pd_s: torch.Tensor) -> torch.Tensor:
    """(B, N_s) bool: the support pixels to ignore in the readout.

    sim (B, N_q, N_s) correlation; s_label, q_label (B, H, W) labels
    {0, 1, 255}; pd_q0, pd_s (B, h, w, 2) query and support logits."""
    b, _, n_s = sim.shape
    h, w = pd_q0.shape[1:3]
    s_small = resize_nearest(s_label[..., None].float(), (h, w))[..., 0]
    s_mask = (s_small > 1).reshape(b, -1)                       # ignored support px
    pd_q_mask0 = torch.argmax(pd_q0, dim=-1).reshape(b, -1)     # (B, N_q)
    q_small = resize_nearest(q_label[..., None].float(), (h, w))[..., 0]
    q_valid = (q_small != 255.0).reshape(b, -1)
    qf_rows = q_valid & (pd_q_mask0 == 1)                       # predicted FG rows
    qb_rows = q_valid & (pd_q_mask0 == 0)

    def stats(rows):
        n_rows = rows.sum(dim=1, keepdim=True).float()
        mean = (sim * rows[..., None].to(sim.dtype)).sum(dim=1) / torch.clamp(n_rows, min=1.0)
        row_mask = rows[..., None].expand(sim.shape).reshape(b, -1)
        flat = sim.reshape(b, -1)
        th = torch.stack([masked_quantile(flat[i], row_mask[i], 0.8) for i in range(b)])
        return mean, th, n_rows[:, 0] > 0

    qf_mean, th_qf, has_qf = stats(qf_rows)
    qb_mean, th_qb, has_qb = stats(qb_rows)
    sf_mask = torch.argmax(pd_s, dim=-1).reshape(b, -1)         # (B, N_s)
    fg_hi = (qf_mean > th_qf[:, None]) & has_qf[:, None]
    bg_hi = (qb_mean > th_qb[:, None]) & has_qb[:, None]
    ig1 = fg_hi & (sf_mask == 0)
    ig3 = bg_hi & (sf_mask == 1)
    ig2 = fg_hi & bg_hi
    return ig1 | ig2 | ig3 | s_mask


def att_weighted_out(sim: torch.Tensor, v: torch.Tensor, temp: float = 20.0,
                     ig_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(sim * temp) readout of v (B, h, w, C) -> (B, h, w, C); ignored
    support entries are set to 1e-5 before the softmax."""
    b, h, w, c = v.shape
    if ig_mask is not None:
        sim = torch.where(ig_mask[:, None, :], torch.full_like(sim, 1e-5), sim)
    attn = torch.softmax(sim * temp, dim=-1)
    return torch.bmm(attn.float(), v.reshape(b, -1, c).float()).reshape(b, h, w, c)


def outer_forward(f_q: torch.Tensor, f_s: torch.Tensor, fq_fea: torch.Tensor,
                  fs_fea: torch.Tensor, s_label: torch.Tensor, q_label: torch.Tensor,
                  pd_q0: torch.Tensor, pd_s: torch.Tensor, gamma: torch.Tensor,
                  temp: float = 20.0, dist: str = "dot"
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The transductive attention blend: (blended query feature (B, h, w, C),
    correlation (B, h, w, h, w), ignore mask (B, N_s)); the caller
    classifies.

    f_q, f_s (B, h, w, C) bottleneck features; fq_fea, fs_fea (B, h, w, C2)
    the tap the correlation reads; labels and logits as ``get_ig_mask``.
    Ignored support entries are set to 1e-5 before ``softmax(sim * temp)``.
    Only ``dist "cos"`` L2-normalises f_s and f_q; every other value
    (``cosN`` too, which configs/pascal_asy.yaml ships) reads them as they
    are, as the JAX package does."""
    b, h, w, c = f_q.shape
    sim = get_corr(fq_fea, fs_fea)
    corr = sim.reshape(b, h, w, h, w)
    ig_mask = get_ig_mask(sim, s_label, q_label, pd_q0, pd_s)
    sim = torch.where(ig_mask[:, None, :], torch.full_like(sim, 1e-5), sim)
    proj_v = f_s
    if dist == "cos":
        proj_v = l2norm(proj_v, dim=-1)
        f_q = l2norm(f_q, dim=-1)
    attn = torch.softmax(sim * temp, dim=-1)
    weighted_v = torch.bmm(attn, proj_v.reshape(b, -1, c).to(attn.dtype)).reshape(b, h, w, c)
    return (weighted_v * gamma + f_q) / (1.0 + gamma), corr, ig_mask


# --------------------------------------------------------------------------- #
# incremental / multi-way helpers (CCA trainers)
# --------------------------------------------------------------------------- #

def reset_cls_wt(weights: torch.Tensor, pre_cls_wt: torch.Tensor, num_classes_tr: int,
                 idx_cls: int, generator: Optional[torch.Generator] = None,
                 new_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Re-seed a (K, C) classifier: rows below ``num_classes_tr`` from the
    pretrained ``pre_cls_wt``, row ``idx_cls`` the given ``new_row`` or a
    U(+-1/sqrt(C)) draw from ``generator`` (on the host)."""
    c = weights.shape[1]
    if new_row is None:
        std = 1.0 / math.sqrt(c)
        new_row = torch.rand((c,), generator=generator, dtype=torch.float32) * (2 * std) - std
    out = weights.clone()
    out[:num_classes_tr] = pre_cls_wt[:num_classes_tr]
    out[idx_cls] = new_row.to(out)
    return out


def reset_spt_label(s_label: torch.Tensor, pred: torch.Tensor, idx_cls) -> torch.Tensor:
    """Support BG pixels -> the base classifier's argmax with class
    ``idx_cls`` suppressed, FG -> ``idx_cls`` (src:119-127). pred (..., H,
    W, K) base logits at label resolution. Sequential, as the reference: BG
    pixels pseudo-labelled 1 also become ``idx_cls``."""
    k = pred.shape[-1]
    novel = torch.arange(k, device=pred.device) == idx_cls
    pred = torch.where(novel, torch.full_like(pred, -1000.0), pred)
    pred_mask = torch.argmax(pred, dim=-1).to(s_label.dtype)
    out = torch.where(s_label == 0, pred_mask, s_label)
    return torch.where(out == 1, torch.as_tensor(idx_cls, dtype=out.dtype,
                                                 device=out.device), out)


def adapt_reset_spt_label_np(s_label: np.ndarray, pred: np.ndarray, pre_cls_wt: np.ndarray,
                             num_classes_tr: int, sub_cls: Optional[int] = None
                             ) -> Tuple[np.ndarray, List[np.ndarray], int]:
    """Episode-adaptive multi-way relabelling on the host (src:130-155):
    (new label, the inherited base-class weight rows, num_cls).

    Reference-exact wart, kept: the relabel mutates ``s_label`` inside the
    frequency loop, so pixels relabelled to num_cls can be matched again by
    a later loop index i == num_cls and folded into background while their
    inherited row stays in the list (model_util.py:146-152)."""
    s_label = s_label.copy()
    pred_mask = pred.argmax(-1)
    if sub_cls is not None and sub_cls > 0:
        pred_mask[pred_mask == sub_cls] = 0

    s_label[s_label == 1] = num_classes_tr      # park FG on a temporary id
    bg = s_label == 0
    s_label[bg] = pred_mask[bg]

    num_cls = 2
    cls_init_wt = []
    freq = np.bincount(s_label.flatten())
    for i in range(1, min(len(freq), num_classes_tr)):
        if 0 < freq[i] <= 300 * len(s_label):
            s_label[s_label == i] = 0
        elif freq[i] > 300 * len(s_label) and 0 < i < num_classes_tr:
            s_label[s_label == i] = num_cls
            num_cls += 1
            cls_init_wt.append(pre_cls_wt[i])
    s_label[s_label == num_classes_tr] = 1
    return s_label, cls_init_wt, num_cls


def compress_pred(pred: torch.Tensor, idx_cls, input_type: str = "lg") -> torch.Tensor:
    """A K-way prediction (..., K) as binary probabilities (..., 2): the
    softmax of logits (``input_type`` lg / lt) or the given probabilities,
    foreground the class ``idx_cls``, background the rest."""
    if input_type in ("lg", "lt"):
        pred = torch.softmax(pred, dim=-1)
    fg = pred[..., idx_cls]
    return torch.stack([1.0 - fg, fg], dim=-1)


def pred2bmask(pred: torch.Tensor, idx_cls: int = 1) -> torch.Tensor:
    """argmax -> int32 binary mask with only ``idx_cls`` as foreground."""
    return (torch.argmax(pred, dim=-1) == idx_cls).int()
