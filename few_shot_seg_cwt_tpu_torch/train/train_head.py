"""Trainer for the extension heads, on the GPU (MMN and the match head).

Counterpart of ``few_shot_seg_cwt_tpu.train.train_head``:

    python -m few_shot_seg_cwt_tpu_torch.train.train_head \
        --config configs/pascal_mmn.yaml \
        --opts data_root <VOC2012 tree> [synthetic_data True use_amp False epochs 1]

Each step draws fresh classifier inits for the episodes, adapts them on the
support features (inner loop), and takes one optimizer step on the head's
parameters over the episodes' mean query loss; the backbone stays frozen.
After every epoch the head is validated on ``test_num`` episodes (mIoU of
the blended prediction and mIoU1 of the attention-only prediction, the
reference's dual model-selection criterion, src/train_trans.py:202-215).
With ``save_models`` the head's ``state_dict`` goes out with ``torch.save``
as ``best.pt``, ``best1.pt`` and ``final.pt``, and every epoch the full
train state as ``train_state.pt``; every line of the run goes to
``log.txt`` beside them (``utils.logging``), with or without
``save_models``. The train state holds the head, optimizer, scheduler, the state
of the default generator that the head's dropout draws from, epoch, best
and best1; each step's classifier inits come from a generator seeded by
(``manual_seed``, epoch, step). ``resume_ckpt`` takes such a state (exact
resume) or a head state_dict (weights only); ``auto_resume`` picks up this
run's own train state; ``stop_after_epochs`` ends the run early. Not
ported: the other heads (ROADMAP queue 1 items 8-10).

Over several cards (``parallel.mesh``)::

    torchrun --nproc_per_node N -m few_shot_seg_cwt_tpu_torch.train.train_head \
        --config configs/pascal_mmn.yaml

each rank trains on ``episode_batch / N`` episodes of every step (the
inits of the global batch drawn alike on every rank, each keeping its
own), the gradients are averaged over the ranks, validation gathers the
ranks' episodes, and rank 0 alone writes ``log.txt`` and the checkpoints;
the train state holds every rank's dropout generator state.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from typing import Dict

import torch

from ..config import parse_args
from ..episodic.heads import HeadEngine
from ..data.loader import infinite
from ..eval.validate import accumulate_fg_iou, batch_generator, exact_batch_sizes, fg_miou
from ..parallel.mesh import (barrier, broadcast_module, check_replicas, distributed_init,
                             is_main_process, rank_world, shutdown, to_host)
from ..utils.ckpt import is_full_train_state, load_ckpt, pack_train_state, save_ckpt
from ..utils.logging import get_logger, log_to
from ..utils.meters import AverageMeter, CompareMeter
from .common import (apply_debug, episodic_loaders, fp32_parity, init_backbone,
                     maybe_auto_resume, rank_rng_state, set_seeds, with_rank_states)
from .optim import build_optimizer


def init_head_trainables(engine: HeadEngine) -> Dict[str, torch.Tensor]:
    """The head's trainable parameters by name. The engine built the head
    with a seeded init (``manual_seed``; U(+-1/sqrt(fan_in)) kernels, zero
    biases), as the JAX package's init does."""
    return dict(engine.head.named_parameters())


def validate_head(cfg, engine: HeadEngine, loader, log=print):
    """Per-class foreground IoU over ``test_num`` episodes for the blended
    (mIoU) and the attention-only (mIoU1) predictions; under a process
    group over the ranks' gathered episodes, as ``eval.validate`` scores."""
    seed = int(cfg.manual_seed or 0)
    rank, world = rank_world()
    acc = {k: defaultdict(float) for k in ("i", "u", "i1", "u1")}
    loss_meter = AverageMeter()
    stream = infinite(loader)
    for b, valid_n in enumerate(exact_batch_sizes(cfg.test_num, loader.batch_size * world)):
        out = to_host(engine.eval_metrics_batch(next(stream),
                                                batch_generator(seed, 0, b, rank)))
        accumulate_fg_iou(acc["i"], acc["u"], out, limit=valid_n)
        accumulate_fg_iou(acc["i1"], acc["u1"], out, suffix="1", limit=valid_n)
        loss_meter.update(float(out["loss"][:valid_n].mean()), n=valid_n)
    miou, miou1 = fg_miou(acc["i"], acc["u"]), fg_miou(acc["i1"], acc["u1"])
    log(f"val: mIoU {miou:.4f} mIoU1 {miou1:.4f} loss {loss_meter.avg:.4f}")
    return miou, miou1, loss_meter.avg


def results_dir(cfg, head_type: str) -> str:
    """Where the head trainer writes its checkpoints and ``log.txt``."""
    return os.path.join("./results", f"{head_type}_{cfg.train_name}/{cfg.arch}{cfg.layers}/"
                        f"split{cfg.train_split}_shot{cfg.shot}/{cfg.exp_name}")


def dropout_rng_state(device: torch.device) -> torch.Tensor:
    """State of the generator the head's dropout draws from: torch's default
    generator on ``device``."""
    return torch.cuda.get_rng_state(device) if device.type == "cuda" else torch.get_rng_state()


def set_dropout_rng_state(device: torch.device, state: torch.Tensor) -> None:
    if device.type == "cuda":
        torch.cuda.set_rng_state(state, device)
    else:
        torch.set_rng_state(state)


def main(cfg, head_type: str = "mmn", device="cuda", log=print) -> float:
    """Train the head for ``epochs`` epochs; returns the best validation mIoU.
    ``log`` receives every line, and ``<sv_path>/log.txt`` gets them too
    from the moment the run's directory is known."""
    device = distributed_init(cfg, device=device)
    log_to(None)   # no tee until this run's directory is known
    log = get_logger(log)
    fp32_parity()
    log(cfg)
    set_seeds(cfg)
    apply_debug(cfg)
    head_type = head_type or cfg.get("head", "mmn")
    train_loader, val_loader = episodic_loaders(cfg, device=device)
    engine = HeadEngine(cfg, head_type, backbone=init_backbone(cfg, log=log), device=device)
    trainables = init_head_trainables(engine)
    optimizer, scheduler = build_optimizer(
        trainables.values(), cfg, base_lr=cfg.trans_lr * cfg.scale_lr,
        iters_per_epoch=max(1, cfg.iter_per_epoch // cfg.episode_batch))
    step = engine.make_train_step(optimizer, scheduler)

    sv_path = results_dir(cfg, head_type)
    log_to(sv_path)

    def save(name: str) -> None:
        if cfg.save_models and is_main_process():
            save_ckpt(os.path.join(sv_path, name), engine.head.state_dict())

    steps_per_epoch = 5 if cfg.debug else max(
        1, min(cfg.iter_per_epoch, len(train_loader.dataset)) // cfg.episode_batch)
    seed = int(cfg.manual_seed or 0)
    best, best1 = 0.0, 0.0
    start_epoch = 1
    state_path = os.path.join(sv_path, "train_state.pt")
    maybe_auto_resume(cfg, state_path, log)
    if cfg.get("resume_ckpt"):
        path = str(cfg.resume_ckpt)
        if is_full_train_state(path):
            state = load_ckpt(path)
            engine.head.load_state_dict(state["model"])
            optimizer.load_state_dict(state["optimizer"])
            scheduler.load_state_dict(state["scheduler"])
            set_dropout_rng_state(engine.device, rank_rng_state(state))
            start_epoch = int(state["meta"]["epoch"]) + 1
            best, best1 = float(state["meta"]["best"]), float(state["meta"]["best1"])
            log(f"=> resumed full head train state after epoch {start_epoch - 1} "
                f"(best {best:.3f} best1 {best1:.3f})")
        else:
            engine.head.load_state_dict(load_ckpt(path))
            log(f"=> resumed head weights from {path}")
    broadcast_module(engine.backbone)
    broadcast_module(engine.head)

    log(f"==> Start training head '{head_type}'")
    for epoch in range(start_epoch, cfg.epochs + 1):
        train_loader.set_epoch(epoch)
        it = iter(train_loader)
        loss_meter, compare = AverageMeter(), CompareMeter()
        t0 = time.time()
        for i in range(1, steps_per_epoch + 1):
            try:
                batch = next(it)
            except StopIteration:
                it = iter(train_loader)
                batch = next(it)
            metrics = step(batch, batch_generator(seed, epoch, i))
            if i % 10 == 0 or (epoch == 1 and i <= 2):
                m = to_host(metrics)   # the ranks' episodes, on every rank
                iou1 = float((m["inter1"] / (m["union1"] + 1e-10)).mean())
                iou0 = float((m["inter0"] / (m["union0"] + 1e-10)).mean())
                loss_meter.update(float(m["loss_mean"].mean()))
                compare.update(iou1, iou0)
                if i % 100 == 0 or (epoch == 1 and i <= 2):
                    log(f"Ep{epoch}/{i * cfg.episode_batch} loss {loss_meter.val:.3f} "
                        f"IoU1 {iou1:.3f} IoU0 {iou0:.3f}")
        log(f"==== Epoch {epoch}: loss {loss_meter.avg:.3f} ({time.time() - t0:.1f}s) ====")

        miou, miou1, _ = validate_head(cfg, engine, val_loader, log=log)
        if miou > best:
            best = miou
            save("best.pt")
        if miou1 > best1:
            best1 = miou1
            save("best1.pt")
        log(f"=> best mIoU {best:.3f} best mIoU1 {best1:.3f}")
        if cfg.save_models:
            rng = dropout_rng_state(engine.device)
            state = with_rank_states(pack_train_state(engine.head, optimizer, rng, epoch, best,
                                                      scheduler=scheduler, best1=best1), rng)
            if is_main_process():
                save_ckpt(state_path, state)
        barrier()   # rank 0's files are whole before any rank reads them
        check_replicas(engine.head)
        stop_after = cfg.get("stop_after_epochs")
        if stop_after and epoch - start_epoch + 1 >= int(stop_after):
            log(f"=> stop_after_epochs={stop_after}: exiting after epoch {epoch}")
            break
    save("final.pt")
    barrier()
    return best


if __name__ == "__main__":
    main(parse_args("Extension-head episodic training (PyTorch/CUDA)"))
    shutdown()
