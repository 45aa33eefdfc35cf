"""Episode-level mask utilities for the match head's ``ignore`` readout.

Counterpart of part of ``few_shot_seg_cwt_tpu.ops.episode_utils``
(reference: src/model/model_util.py:178-236):

* ``masked_quantile``: ``torch.quantile`` over the masked entries, linear
  interpolation, by a sort of the whole vector with masked-out entries
  pushed to the end;
* ``get_ig_mask`` (src:178-221): the support pixels to ignore, from
  quantile-thresholded query-FG/BG similarity statistics crossed with the
  support prediction;
* ``att_weighted_out`` (src:224-236): the softmax readout with ignored
  entries set to 1e-5 (MatchNet's own readout uses 1e-4, as the
  reference's two sites do).

The rest of the JAX module (``outer_forward``, the reset and compress
helpers of the incremental trainers) is not ported (ROADMAP queue 1 item
10).
"""

from __future__ import annotations

from typing import Optional

import torch

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
