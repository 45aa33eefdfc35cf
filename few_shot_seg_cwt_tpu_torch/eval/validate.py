"""Episodic evaluation loop (the protocol that defines all baselines).

Counterpart of ``few_shot_seg_cwt_tpu.eval.validate`` (reference:
src/test.py:103-254): ``n_runs`` runs x ``test_num`` episodes; per-class
foreground intersection/union accumulated over episodes (background never
counted); per-class IoU = I/U; run mIoU = mean over classes; final score =
mean over runs; device time per run reported.

Episodes stream through ``EpisodicEngine.eval_metrics_batch``; only the
(E, K) metric arrays and class ids come back to the host. The classifier
inits of batch b of run r are drawn from a ``torch.Generator`` seeded from
(manual_seed, r, b), so a run is reproducible on any device. Single process;
the mesh and multi-process branches of the JAX package are not ported yet.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..utils.meters import AverageMeter


def accumulate_fg_iou(inter_acc: Dict[int, float], union_acc: Dict[int, float],
                      out: Dict, suffix: str = "",
                      limit: Optional[int] = None) -> None:
    """Per-class foreground I/U accumulation; ``limit`` scores only the first
    N episodes of the batch (the tail batch carries filler episodes)."""
    classes = np.asarray(out["cls"])
    inter = np.asarray(out[f"inter{suffix}"])
    union = np.asarray(out[f"union{suffix}"])
    n = len(classes) if limit is None else min(limit, len(classes))
    for i in range(n):
        c = int(classes[i])
        inter_acc[c] += float(inter[i, 1])
        union_acc[c] += float(union[i, 1])


def exact_batch_sizes(test_num: int, e_batch: int):
    """Per-batch valid-episode counts so exactly ``test_num`` episodes score."""
    sizes = [e_batch] * (max(test_num, 1) // e_batch)
    rem = max(test_num, 1) - sum(sizes)
    if rem:
        sizes.append(rem)
    return sizes


def fg_miou(inter_acc: Dict[int, float], union_acc: Dict[int, float]) -> float:
    if not union_acc:
        return 0.0
    return float(np.mean(
        [inter_acc[c] / (union_acc[c] + 1e-10) for c in union_acc]
    ))


def batch_generator(seed: int, run: int, b: int) -> torch.Generator:
    """The host generator for the classifier inits of batch ``b`` of ``run``."""
    return torch.Generator().manual_seed(seed + (run * 1_000_003 + b) * 65_537)


def validate_transformer(cfg, engine, loader: Iterable[Dict],
                         log=print) -> Tuple[float, float]:
    """Full CWT evaluation; returns (mean mIoU over runs, mean loss).

    ``loader`` is re-iterable: each run iterates it afresh and takes
    ``ceil(test_num / E)`` batches of E episodes (E from the first batch).
    """
    test_num = cfg.test_num
    seed = int(cfg.manual_seed if cfg.manual_seed is not None else 0)
    run_mious = np.zeros(cfg.n_runs)
    run_losses = np.zeros(cfg.n_runs)
    runtimes = np.zeros(cfg.n_runs)

    for run in range(cfg.n_runs):
        cls_inter: Dict[int, float] = defaultdict(float)
        cls_union: Dict[int, float] = defaultdict(float)
        cls_inter0: Dict[int, float] = defaultdict(float)
        cls_union0: Dict[int, float] = defaultdict(float)
        loss_meter = AverageMeter()
        stream = iter(loader)
        batch = next(stream)
        e_batch = len(batch["cls"])
        t_run = 0.0
        seen = 0
        for b, valid_n in enumerate(exact_batch_sizes(test_num, e_batch)):
            if b > 0:
                batch = next(stream)
            t0 = time.time()
            out = engine.eval_metrics_batch(batch, batch_generator(seed, run, b))
            out = {k: v.cpu().numpy() for k, v in out.items()}  # waits for the device
            t_run += time.time() - t0
            seen += valid_n

            # foreground channel only; background never enters the score
            accumulate_fg_iou(cls_inter, cls_union, out, limit=valid_n)
            accumulate_fg_iou(cls_inter0, cls_union0, out, suffix="0", limit=valid_n)
            loss_meter.update(float(out["loss"][:valid_n].mean()), n=valid_n)

            if seen % max(e_batch, 200 // e_batch * e_batch) == 0:
                log(
                    f"Test: [{seen}/{test_num}] "
                    f"mIoU {fg_miou(cls_inter, cls_union):.4f} "
                    f"mIoU0 {fg_miou(cls_inter0, cls_union0):.4f} "
                    f"Loss {loss_meter.val:.4f} ({loss_meter.avg:.4f})"
                )

        miou = fg_miou(cls_inter, cls_union)
        log(f"mIoU---Val result: mIoU {miou:.4f}.")
        for c in sorted(cls_union):
            log(f"Class {c} : {cls_inter[c] / (cls_union[c] + 1e-10):.4f}")
        run_mious[run] = miou
        run_losses[run] = loss_meter.avg
        runtimes[run] = t_run

    log(f"Average mIoU over {cfg.n_runs} runs --- {run_mious.mean():.4f}.")
    log(f"Average runtime / run --- {runtimes.mean():.4f}.")
    return float(run_mious.mean()), float(run_losses.mean())
