"""Stage-2 CWT meta-training (the paper's trainer), on the GPU.

Counterpart of ``few_shot_seg_cwt_tpu.train.train_cwt``:

    python -m few_shot_seg_cwt_tpu_torch.train.train_cwt --config configs/pascal.yaml \
        --opts data_root <VOC2012 tree> [synthetic_data True epochs 1]

Each step draws fresh classifier inits for ``episode_batch`` episodes,
adapts them on the dropped-out support features (the inner loop: K1, or K2
with ``FSS_INNER_TILE`` 2 or 4), and takes one SGD step (no schedule, as the
reference's stage 2) on the transformer alone over the episodes' mean
query loss. One ``torch.Generator`` seeded from ``manual_seed`` draws every
step's inits and dropout masks. Every 10th step (and the first five) reads
the train I/U; the others run the loss-only step. After each epoch the
transformer is validated on ``test_num`` episodes.

With ``save_models`` the trainer writes into ``trans_ckpt_dir(cfg)``:
``best.pth`` (the transformer's state_dict) when validation mIoU improves,
``train_state.pth`` every epoch (transformer, optimizer, the generator's
state, epoch, best), ``final.pth``, and ``log.txt`` with every line of the
run (``utils.logging``). ``train.test`` with ``ckpt_used
best`` evaluates ``best.pth``. ``resume_ckpt`` takes a train state (exact
resume) or a transformer state_dict (weights only); ``auto_resume`` picks
up this run's own train state; ``stop_after_epochs`` ends the run early.
Episodes come from ``train.common.episodic_loaders`` (a dataset tree, or
synthetic episodes), reshuffled each epoch.

Over several cards (``parallel.mesh``)::

    torchrun --nproc_per_node N -m few_shot_seg_cwt_tpu_torch.train.train_cwt \
        --config configs/pascal.yaml

each rank takes ``episode_batch / N`` episodes of every step; every rank's
generator draws the global batch's inits and dropout masks and keeps its
rows, the gradients are averaged over the ranks, validation gathers the
ranks' episodes, and rank 0 alone writes ``log.txt`` and the checkpoints.
``train_state.pth`` holds every rank's generator state; a resume needs the
world size that wrote it.
"""

from __future__ import annotations

import os
import time

import torch

from ..config import parse_args
from ..episodic.engine import EpisodicEngine
from ..eval.validate import validate_transformer
from ..parallel.mesh import (barrier, broadcast_module, check_replicas, distributed_init,
                             is_main_process, shutdown, to_host)
from ..utils.ckpt import is_full_train_state, load_ckpt, pack_train_state, save_ckpt
from ..utils.logging import get_logger, log_to
from ..utils.meters import AverageMeter
from .common import (apply_debug, episodic_loaders, fp32_parity, init_backbone, init_cwt,
                     maybe_auto_resume, rank_rng_state, set_seeds, trans_ckpt_dir,
                     with_rank_states)
from .optim import build_optimizer


def main(cfg, device="cuda", log=print) -> float:
    """Meta-train the transformer for ``epochs`` epochs; returns the best
    validation mIoU. ``log`` receives every line; with ``save_models`` the
    lines also go to ``<save_dir>/log.txt``."""
    device = distributed_init(cfg, device=device)
    log_to(None)   # no tee until this run's directory is known
    log = get_logger(log)
    fp32_parity()
    log(cfg)
    set_seeds(cfg)
    apply_debug(cfg)
    train_loader, val_loader = episodic_loaders(cfg, device=device)
    engine = EpisodicEngine(cfg, backbone=init_backbone(cfg, log=log), cwt=init_cwt(cfg),
                            device=device)
    # reference: one param group at trans_lr * scale_lr, no scheduler in stage 2
    optimizer, _ = build_optimizer(engine.cwt.parameters(), cfg,
                                   base_lr=cfg.trans_lr * cfg.scale_lr, use_schedule=False)
    train_step = engine.make_train_step(optimizer)
    train_step_fast = engine.make_train_step(optimizer, with_metrics=False)
    generator = torch.Generator().manual_seed(int(cfg.manual_seed or 0))
    save_dir = trans_ckpt_dir(cfg)
    if cfg.save_models and is_main_process():  # a run without checkpoints keeps no log.txt
        log_to(save_dir)
    state_path = os.path.join(save_dir, "train_state.pth")

    start_epoch, best = 0, 0.0
    maybe_auto_resume(cfg, state_path, log)
    if cfg.get("resume_ckpt"):
        path = str(cfg.resume_ckpt)
        if is_full_train_state(path):
            state = load_ckpt(path)
            engine.cwt.load_state_dict(state["model"])
            optimizer.load_state_dict(state["optimizer"])
            generator.set_state(rank_rng_state(state))
            start_epoch, best = int(state["meta"]["epoch"]), float(state["meta"]["best"])
            log(f"=> resumed full train state at epoch {start_epoch} (best {best:.3f})")
        else:
            engine.cwt.load_state_dict(load_ckpt(path))
            log(f"=> resumed transformer weights from {path}")
    broadcast_module(engine.backbone)
    broadcast_module(engine.cwt)

    e = int(cfg.episode_batch)
    iter_per_epoch = 5 * e if cfg.debug else min(cfg.iter_per_epoch, len(train_loader.dataset))
    steps_per_epoch = max(1, iter_per_epoch // e)
    log("==> Start training")
    for epoch in range(start_epoch, cfg.epochs):
        train_loader.set_epoch(epoch)
        it = iter(train_loader)
        loss_meter, iou_meter, iou0_meter = AverageMeter(), AverageMeter(), AverageMeter()
        t0 = time.time()
        for i in range(steps_per_epoch):
            try:
                batch = next(it)
            except StopIteration:
                it = iter(train_loader)
                batch = next(it)
            log_step = i % 10 == 0 or (epoch == 0 and i < 5)
            metrics = (train_step if log_step else train_step_fast)(batch, generator)
            if log_step:
                m = to_host(metrics)   # the ranks' episodes, on every rank
                iou = float((m["inter"] / (m["union"] + 1e-10)).mean())
                iou0 = float((m["inter0"] / (m["union0"] + 1e-10)).mean())
                loss_meter.update(float(m["loss"].mean()))
                iou_meter.update(iou)
                iou0_meter.update(iou0)
                if i % 100 == 0 or (epoch == 0 and i < 5):
                    log(f"iter {i * e} loss {float(m['loss'].mean()):.4f} mIoU {iou:.3f} "
                        f"mIoU0 {iou0:.3f}")
        log(f"Epoch {epoch + 1}: mIoU {iou_meter.avg:.3f}, loss {loss_meter.avg:.3f}, "
            f"mIoU0 {iou0_meter.avg:.3f} ({time.time() - t0:.1f}s)")

        val_miou, _ = validate_transformer(cfg, engine, val_loader, log=log)
        if val_miou > best:
            best = val_miou
            if cfg.save_models and is_main_process():
                path = os.path.join(save_dir, "best.pth")
                log(f"Saving checkpoint to: {path}")
                save_ckpt(path, engine.cwt.state_dict())
        if cfg.save_models:
            rng = generator.get_state()
            state = with_rank_states(pack_train_state(engine.cwt, optimizer, rng, epoch + 1,
                                                      best), rng)
            if is_main_process():
                save_ckpt(state_path, state)
        barrier()   # rank 0's files are whole before any rank reads them
        check_replicas(engine.cwt, generator.get_state())
        log(f"=> Max_mIoU = {best:.3f}")
        stop_after = cfg.get("stop_after_epochs")
        if stop_after and epoch - start_epoch + 1 >= int(stop_after):
            log(f"=> stop_after_epochs={stop_after}: exiting after epoch {epoch + 1}")
            break

    if cfg.save_models and is_main_process():
        save_ckpt(os.path.join(save_dir, "final.pth"), engine.cwt.state_dict())
    barrier()
    return best


if __name__ == "__main__":
    main(parse_args("Training classifier weight transformer (PyTorch/CUDA)"))
    shutdown()
