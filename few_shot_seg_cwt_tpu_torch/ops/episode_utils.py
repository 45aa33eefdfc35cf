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
  gamma)``.

The rest of the JAX module (``reset_cls_wt``, ``reset_spt_label``,
``adapt_reset_spt_label_np``, ``compress_pred`` and ``pred2bmask``, the
incremental trainers' helpers) is not ported (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

from typing import Optional, Tuple

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
