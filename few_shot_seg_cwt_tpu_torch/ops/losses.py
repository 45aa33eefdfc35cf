"""Segmentation losses with PyTorch-exact reductions, NHWC logits.

Counterparts of ``few_shot_seg_cwt_tpu.ops.losses``: class-weighted CE with
ignore index 255 and the weight-normalised mean of ``nn.CrossEntropyLoss``,
its K=2 form on the logit difference, and the per-episode dynamic class
weights [1, n_bg/n_fg].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def weighted_cross_entropy(
    logits: torch.Tensor,
    target: torch.Tensor,
    class_weights: torch.Tensor,
    ignore_index: int = 255,
) -> torch.Tensor:
    """nn.CrossEntropyLoss(weight=w, ignore_index=255) with mean reduction.

    The weighted mean divides by the sum of the counted pixels' weights, not
    by the pixel count. logits: (..., H, W, K); target: (..., H, W).
    """
    valid = target != ignore_index
    tgt = torch.where(valid, target, torch.zeros_like(target)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    cw = class_weights.float()
    nll = -torch.gather(logp, -1, tgt.unsqueeze(-1)).squeeze(-1)
    w = cw[tgt] * valid.float()
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1e-12)


def binary_weighted_ce_from_diff(
    diff: torch.Tensor,
    target: torch.Tensor,
    class_weights: torch.Tensor,
    ignore_index: int = 255,
) -> torch.Tensor:
    """``weighted_cross_entropy`` for K=2 from the logit difference d = l1 - l0.

    Per pixel, logsumexp(l0, l1) - l_y = softplus(d) - y*d.
    """
    valid = target != ignore_index
    y = (target == 1) & valid
    d = diff.float()
    nll = F.softplus(d) - torch.where(y, d, torch.zeros_like(d))
    cw = class_weights.float()
    w = torch.where(y, cw[1], cw[0]) * valid.float()
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1e-12)


def class_balance_weights(
    label: torch.Tensor,
    num_classes: int = 2,
    fg_idx: int = 1,
    tp: float = 1.0,
    ignore_index: int = 255,
) -> torch.Tensor:
    """Per-episode dynamic class weights [1, (n_bg/n_fg)**tp].

    bg counts every valid non-fg pixel; 255 is excluded.
    """
    valid = label != ignore_index
    fg_cnt = torch.sum((label == fg_idx) & valid).float()
    bg_cnt = torch.sum(valid).float() - fg_cnt
    w = torch.ones((num_classes,), dtype=torch.float32, device=label.device)
    w[fg_idx] = (bg_cnt / torch.clamp(fg_cnt, min=1e-12)) ** tp
    return w
