"""Segmentation losses with PyTorch-exact reductions, NHWC logits.

Counterparts of ``few_shot_seg_cwt_tpu.ops.losses``: class-weighted CE with
ignore index 255 and the weight-normalised mean of ``nn.CrossEntropyLoss``,
its K=2 form on the logit difference, the per-episode dynamic class
weights [1, n_bg/n_fg], the binary dice loss, the ``seg_loss`` dispatcher
of the head trainers and stage-1 pretraining's label-smoothing CE.
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


def cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                  ignore_index: int = 255) -> torch.Tensor:
    """Unweighted nn.CrossEntropyLoss(ignore_index=255), mean over valid pixels."""
    ones = torch.ones((logits.shape[-1],), dtype=torch.float32, device=logits.device)
    return weighted_cross_entropy(logits, target, ones, ignore_index)


def smoothed_cross_entropy(logits: torch.Tensor, target: torch.Tensor, num_classes: int,
                           smoothing: float = 0.1, ignore_index: int = 255) -> torch.Tensor:
    """Label-smoothing CE of stage-1 pretraining (src/pretrain.py:196-218).

    The true class gets 1 - eps and every other class eps / (C - 1).
    Pixels labelled ``ignore_index`` are scattered to class 0 for the
    one-hot, as the reference does, and masked out of the mean.
    logits: (..., H, W, C); target: (..., H, W).
    """
    valid = target != ignore_index
    tgt = torch.where(valid, target, torch.zeros_like(target)).long()
    onehot = F.one_hot(tgt, num_classes).float()
    smoothed = onehot * (1.0 - smoothing) + (1.0 - onehot) * (
        smoothing / max(num_classes - 1, 1))
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss_pix = -torch.sum(smoothed * logp, dim=-1) * valid.float()
    return torch.sum(loss_pix) / torch.clamp(torch.sum(valid), min=1)


def weighted_dice_loss(
    logits: torch.Tensor,
    target: torch.Tensor,
    weighted_val: float = 1.0,
    reduction: str = "sum",
    input_type: str = "lg",
    eps: float = 1e-8,
) -> torch.Tensor:
    """Binary dice over sigmoid'ed per-class maps (src/model/model_util.py:40-73).

    logits (B, H, W, 2), target (B, H, W) in {0, 1, 255}; 255 drops out of
    both one-hot planes. The leading axis is the batch B, whatever it is: an
    unbatched (H, W, 2) input scores each row as one item, as the JAX
    package's does.
    """
    tgt = torch.stack([(target == 0).float(), (target == 1).float()], dim=-1)
    pred = logits.float()
    if input_type in ("lg", "lt"):
        pred = torch.sigmoid(pred)
    b = tgt.shape[0]
    pred = pred.reshape(b, -1, 2).transpose(1, 2).reshape(b * 2, -1)
    tgt = tgt.reshape(b, -1, 2).transpose(1, 2).reshape(b * 2, -1)
    denom = torch.sum(pred ** 2, -1) + torch.sum(tgt ** 2, -1)
    loss = (1.0 - 2.0 * torch.sum(pred * tgt, -1) / torch.clamp(denom, min=eps)) * weighted_val
    if reduction == "sum":
        return torch.sum(loss) / b
    if reduction == "mean":
        return torch.mean(loss)
    return loss


def seg_loss(logits: torch.Tensor, target: torch.Tensor, loss_type: str = "wt_ce",
             num_classes: int = 2, fg_idx: int = 1, input_type: str = "lg") -> torch.Tensor:
    """SegLoss dispatcher (src/model/model_util.py:9-24)."""
    if loss_type in ("wt_dc", "dc"):
        return weighted_dice_loss(logits, target, input_type=input_type)
    if loss_type == "ce":
        return cross_entropy(logits, target)
    w = class_balance_weights(target, num_classes=num_classes, fg_idx=fg_idx)
    return weighted_cross_entropy(logits, target, w)
