"""Optimizers and learning-rate schedules (torch.optim).

Counterpart of ``few_shot_seg_cwt_tpu.train.optim`` (reference:
src/optimizer.py:8-35): SGD (momentum, weight decay, nesterov) or Adam, and
the step / multi_step / cosine schedules stepped once per iteration. The
JAX package builds them with optax so that they behave as torch's do:
weight decay is added to the gradient before the momentum buffer (torch's
``weight_decay``), and cosine anneals to eta_min 1e-6. Here the schedule
is a ``LambdaLR`` over the same step -> lr function.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Tuple

import torch


def build_lr_schedule(cfg, base_lr: float, iters_per_epoch: int) -> Callable[[int], float]:
    """step -> lr, the optax schedule of the JAX package at the same step."""
    sched = cfg.get("scheduler", None)
    if sched is None or sched == "None":
        return lambda step: base_lr
    if sched == "cosine":
        total = max(1, iters_per_epoch * cfg.epochs)
        eta_min = 1e-6

        def cosine(step: int) -> float:
            t = min(step, total) / total
            return (base_lr - eta_min) * 0.5 * (1.0 + math.cos(math.pi * t)) + eta_min

        return cosine
    if sched == "step":
        period = cfg.lr_stepsize * iters_per_epoch  # epoch-level StepLR
        return lambda step: base_lr * cfg.gamma ** (step // period)
    if sched == "multi_step":
        bounds = sorted({int(m) * iters_per_epoch for m in cfg.milestones})
        return lambda step: base_lr * cfg.gamma ** sum(step >= b for b in bounds)
    raise ValueError(f"unknown scheduler {sched}")


def build_optimizer(params: Iterable[torch.nn.Parameter], cfg, base_lr: float,
                    iters_per_epoch: int = 1, use_schedule: bool = True
                    ) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """(optimizer, per-iteration scheduler); call ``scheduler.step()`` after
    every ``optimizer.step()``. ``use_schedule=False`` keeps ``base_lr``
    whatever ``cfg.scheduler`` says (the stage-2 CWT trainer's setting)."""
    if cfg.main_optim == "SGD":
        opt = torch.optim.SGD(params, lr=base_lr, momentum=cfg.momentum,
                              weight_decay=cfg.weight_decay, nesterov=cfg.nesterov)
    elif cfg.main_optim == "Adam":
        opt = torch.optim.Adam(params, lr=base_lr, weight_decay=cfg.weight_decay)
    else:
        raise ValueError(f"unknown optimizer {cfg.main_optim}")
    schedule = (build_lr_schedule(cfg, base_lr, iters_per_epoch) if use_schedule
                else lambda step: base_lr)
    factor = (lambda step: schedule(step) / base_lr) if base_lr else (lambda step: 1.0)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)
