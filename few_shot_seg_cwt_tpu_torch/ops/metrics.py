"""IoU metrics with the reference's counting rules, as on-device reductions.

Counterpart of ``few_shot_seg_cwt_tpu.ops.metrics.intersection_and_union``
(reference ``intersectionAndUnionGPU``, which sets preds[target==255]=255).
"""

from __future__ import annotations

from typing import Tuple

import torch


def intersection_and_union(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    ignore_index: int = 255,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-class (intersection, union, target) pixel areas over the last
    two axes (leading axes are a batch).

    Pixels whose target is ``ignore_index`` are removed from predictions and
    targets alike. Returns three (..., num_classes) float32 tensors.
    """
    preds = preds.flatten(-2)
    target = target.flatten(-2)
    valid = target != ignore_index
    inters, outs, tgts = [], [], []
    for c in range(num_classes):
        p = (preds == c) & valid
        t = (target == c) & valid
        inters.append(torch.sum(p & t, dim=-1))
        outs.append(torch.sum(p, dim=-1))
        tgts.append(torch.sum(t, dim=-1))
    area_inter = torch.stack(inters, dim=-1).float()
    area_out = torch.stack(outs, dim=-1).float()
    area_tgt = torch.stack(tgts, dim=-1).float()
    return area_inter, area_out + area_tgt - area_inter, area_tgt
