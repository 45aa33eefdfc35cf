"""Episodic evaluation loop (the protocol that defines all baselines).

Counterpart of ``few_shot_seg_cwt_tpu.eval.validate`` (reference:
src/test.py:103-254): ``n_runs`` runs x ``test_num`` episodes; per-class
foreground intersection/union accumulated over episodes (background never
counted); per-class IoU = I/U; run mIoU = mean over classes; final score =
mean over runs; device time per run reported.

Episodes stream through ``EpisodicEngine.eval_metrics_batch``; only the
(E, K) metric arrays and class ids come back to the host. The classifier
inits of batch b of run r are drawn from a ``torch.Generator`` seeded from
(manual_seed, r, b), so a run is reproducible on any device. Each run
walks a fresh wrap-around stream of the loader; a replayed episode log
(``replay``) is one stream across runs, so run r scores log episodes
r * test_num onwards, as the reference's persistent iterator does.
``episodic_validate`` is the same protocol without the transformer, scoring
the adapted inner-loop classifier (stage-1 pretraining's episodic
validation). ``profile_dir`` traces ``validate_transformer``'s runs with
``torch.profiler``.

Under a process group (``parallel.mesh``) each rank scores its slice of
every batch (``train.common.episodic_val_loader``: rank-strided), draws its
inits from the generator of (manual_seed, r, b, rank) as the JAX package
folds ``process_index`` into each batch's key, and the per-episode metrics
come back to every rank in rank order (``to_host``) before the global
batch is scored, so every rank computes the same mIoU.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..data.loader import infinite
from ..parallel.mesh import rank_world, to_host
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


def batch_generator(seed: int, run: int, b: int, rank: int = 0) -> torch.Generator:
    """The host generator for the classifier inits of batch ``b`` of ``run``
    on process ``rank`` (the term the JAX package folds into the batch's
    key; rank 0's is the single-process generator)."""
    return torch.Generator().manual_seed(seed + (run * 1_000_003 + b) * 65_537 + rank)


def validate_transformer(cfg, engine, loader: Iterable[Dict],
                         log=print) -> Tuple[float, float]:
    """Full CWT evaluation; returns (mean mIoU over runs, mean loss).

    ``loader`` is re-iterable with a ``batch_size`` E (``EpisodeLoader``; a
    rank's E under a process group, of a global batch of E * world); a run
    takes ``ceil(test_num / (E * world))`` batches and scores exactly
    ``test_num`` episodes. With ``profile_dir`` a ``torch.profiler`` trace of the runs
    (host and, on the card, device activity) is written there as Chrome-trace
    JSON (``trace_path``), as the JAX package's ``jax.profiler`` trace is.
    """
    test_num = cfg.test_num
    rank, world = rank_world()
    e_batch = loader.batch_size * world
    seed = int(cfg.manual_seed if cfg.manual_seed is not None else 0)
    run_mious = np.zeros(cfg.n_runs)
    run_losses = np.zeros(cfg.n_runs)
    runtimes = np.zeros(cfg.n_runs)

    # replay: the recorded stream is one walk across runs, so a run must not
    # take filler episodes past its boundary
    replaying = bool(cfg.get("replay"))
    if replaying and test_num % e_batch:
        raise ValueError(
            f"replay: episode_batch {e_batch} must divide test_num {test_num} so "
            "run boundaries match the recorded stream")
    persistent_stream = infinite(loader) if replaying else None

    profile_dir = cfg.get("profile_dir")
    profiler = start_trace(engine.device) if profile_dir else None

    for run in range(cfg.n_runs):
        cls_inter: Dict[int, float] = defaultdict(float)
        cls_union: Dict[int, float] = defaultdict(float)
        cls_inter0: Dict[int, float] = defaultdict(float)
        cls_union0: Dict[int, float] = defaultdict(float)
        loss_meter = AverageMeter()
        stream = persistent_stream if replaying else infinite(loader)
        t_run = 0.0
        seen = 0
        for b, valid_n in enumerate(exact_batch_sizes(test_num, e_batch)):
            batch = next(stream)
            t0 = time.time()
            out = engine.eval_metrics_batch(batch, batch_generator(seed, run, b, rank))
            out = to_host(out)  # waits for the device; gathers the ranks' episodes
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

    if profiler is not None:
        log(f"=> profile trace written to {stop_trace(profiler, profile_dir)}")
    log(f"Average mIoU over {cfg.n_runs} runs --- {run_mious.mean():.4f}.")
    log(f"Average runtime / run --- {runtimes.mean():.4f}.")
    return float(run_mious.mean()), float(run_losses.mean())


def start_trace(device) -> torch.profiler.profile:
    """A started ``torch.profiler`` session: host activity, and the card's
    kernels when ``device`` is a CUDA device."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def trace_path(profile_dir: str) -> str:
    """Where ``stop_trace`` writes: one file a process and second."""
    return os.path.join(profile_dir, f"validate_transformer.{os.getpid()}."
                                     f"{int(time.time())}.trace.json")


def stop_trace(profiler: torch.profiler.profile, profile_dir: str) -> str:
    """Stop ``profiler`` and write its Chrome trace under ``profile_dir``;
    returns the file's path."""
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = trace_path(profile_dir)
    profiler.export_chrome_trace(path)
    return path


def episodic_validate(cfg, engine, loader: Iterable[Dict],
                      log=print) -> Tuple[float, float]:
    """No-transformer episodic evaluation (reference src/test.py:257-371):
    the protocol of ``validate_transformer`` scored on the adapted
    classifier's own query logits (``eval_metrics_batch_no_cwt``) and its
    own CE. Each run walks a fresh stream of ``loader``; returns (mean
    mIoU over runs, mean loss)."""
    rank, world = rank_world()
    e_batch = loader.batch_size * world
    seed = int(cfg.manual_seed if cfg.manual_seed is not None else 0)
    run_mious = np.zeros(cfg.n_runs)
    run_losses = np.zeros(cfg.n_runs)
    for run in range(cfg.n_runs):
        cls_inter: Dict[int, float] = defaultdict(float)
        cls_union: Dict[int, float] = defaultdict(float)
        loss_meter = AverageMeter()
        stream = infinite(loader)
        for b, valid_n in enumerate(exact_batch_sizes(cfg.test_num, e_batch)):
            out = to_host(engine.eval_metrics_batch_no_cwt(
                next(stream), batch_generator(seed, run, b, rank)))
            accumulate_fg_iou(cls_inter, cls_union, out, suffix="0", limit=valid_n)
            loss_meter.update(float(out["loss0"][:valid_n].mean()), n=valid_n)
        run_mious[run] = fg_miou(cls_inter, cls_union)
        run_losses[run] = loss_meter.avg
        log(f"episodic_validate run {run}: mIoU {run_mious[run]:.4f}")
    return float(run_mious.mean()), float(run_losses.mean())
