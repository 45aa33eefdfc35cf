"""Incremental multi-way CCA trainer, on the GPU (reference: src/train_cca.py).

Counterpart of ``few_shot_seg_cwt_tpu.train.train_cca``:

    python -m few_shot_seg_cwt_tpu_torch.train.train_cca \
        --config configs/pascal_cca.yaml --opts data_root <VOC2012 tree>

The MMN head over the K-way incremental episodic classifier
(``episodic.cca.CCAEngine``): base rows from the stage-1 classifier, which
this trainer keeps when it reads the stage-1 weights (``init_backbone``
with ``skip_classifier=False``), the novel row re-seeded, the support BG
pseudo-labelled, the Adapt_SegLoss inner loop, binary-compressed losses.
The head's parameters train with ``train_head``'s optimizer and schedule
(``trans_lr * scale_lr``); each step's novel rows come from a generator
seeded by (``manual_seed``, epoch, step). ``adaptive`` (``train_cca1``)
adds the episode-adaptive relabel pass on the host before each step and
each validation batch, drawing from ``np.random.default_rng([manual_seed,
epoch])``, so a resumed run draws what an uninterrupted one draws.

After every epoch the head is validated on ``test_num`` episodes: the
per-class foreground IoU of the readout's compressed prediction
(``inter1``/``union1``), exactly ``test_num`` episodes. With
``save_models`` the head's ``state_dict`` goes to
``./results/cca[1]_<train_name>/<arch><layers>/split<s>_shot<k>/<exp_name>/best.pt``
at the best mIoU, and every epoch the full train state to
``train_state.pt`` (head, optimizer, scheduler, the dropout generator's
state, epoch, best), which ``resume_ckpt`` or ``auto_resume`` read back;
``stop_after_epochs`` ends a run early; every line goes to ``log.txt``
there.

Under ``torchrun`` (``parallel.mesh``) the non-adaptive trainer runs as
``train_head`` does: each rank takes its slice of every global batch, the
gradients are averaged, validation gathers the ranks' episodes. The
adaptive trainer is single-process, as in JAX (its host pass runs per
process batch).
"""

from __future__ import annotations

import os
import time
from collections import defaultdict

import numpy as np

from ..config import parse_args
from ..data.loader import infinite
from ..episodic.cca import CCAEngine, adaptive_relabel_batch, make_base_preds_fn
from ..eval.validate import accumulate_fg_iou, batch_generator, exact_batch_sizes, fg_miou
from ..parallel.mesh import (barrier, broadcast_module, check_replicas, distributed_init,
                             is_main_process, rank_world, shutdown, to_host)
from ..utils.ckpt import is_full_train_state, load_ckpt, pack_train_state, save_ckpt
from ..utils.logging import get_logger, log_to
from ..utils.meters import AverageMeter
from .common import (apply_debug, episodic_loaders, fp32_parity, init_backbone,
                     maybe_auto_resume, rank_rng_state, set_seeds, with_rank_states)
from .optim import build_optimizer
from .train_head import dropout_rng_state, set_dropout_rng_state


def results_dir(cfg, adaptive: bool) -> str:
    return os.path.join("./results", f"cca{'1' if adaptive else ''}_{cfg.train_name}/"
                        f"{cfg.arch}{cfg.layers}/split{cfg.train_split}_shot{cfg.shot}/"
                        f"{cfg.exp_name}")


def main(cfg, adaptive: bool = False, device="cuda", log=print) -> float:
    """Train the CCA head for ``epochs`` epochs; returns the best mIoU."""
    device = distributed_init(cfg, device=device)
    log_to(None)   # no tee until this run's directory is known
    log = get_logger(log)
    fp32_parity()
    log(cfg)
    set_seeds(cfg)
    apply_debug(cfg)
    if int(cfg.num_classes_tr) <= 2:
        raise ValueError("cca needs a multi-way base classifier (num_classes_tr > 2)")
    rank, world = rank_world()
    if adaptive and world > 1:
        raise ValueError("train_cca1 runs on one process: its relabel pass is per batch "
                         "on the host, as in the JAX package")
    train_loader, val_loader = episodic_loaders(cfg, device=device)
    # the stage-1 classifier stays: its rows are the base classes
    engine = CCAEngine(cfg, adaptive=adaptive, device=device,
                       backbone=init_backbone(cfg, log=log, skip_classifier=False))
    base_preds = make_base_preds_fn(cfg, engine) if adaptive else None
    optimizer, scheduler = build_optimizer(
        engine.head.parameters(), cfg, base_lr=cfg.trans_lr * cfg.scale_lr,
        iters_per_epoch=max(1, cfg.iter_per_epoch // cfg.episode_batch))
    step = engine.make_train_step(optimizer, scheduler)

    name = f"cca{'1' if adaptive else ''}"
    sv_path = results_dir(cfg, adaptive)
    log_to(sv_path)
    steps_per_epoch = 5 if cfg.debug else max(
        1, min(cfg.iter_per_epoch, len(train_loader.dataset)) // cfg.episode_batch)
    seed = int(cfg.manual_seed or 0)
    best, start_epoch = 0.0, 1
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
            start_epoch, best = int(state["meta"]["epoch"]) + 1, float(state["meta"]["best"])
            log(f"=> resumed full {name} train state after epoch {start_epoch - 1} "
                f"(best {best:.3f})")
        else:
            engine.head.load_state_dict(load_ckpt(path))
            log(f"=> resumed {name} weights from {path}")
    broadcast_module(engine.backbone)
    broadcast_module(engine.head)

    log(f"==> Start training {name}")
    for epoch in range(start_epoch, cfg.epochs + 1):
        # per-epoch stream: the relabel draws are resume-exact
        relabel_rng = np.random.default_rng([seed, epoch])

        def episodes_of(batch):
            if not adaptive:
                return batch
            return adaptive_relabel_batch(cfg, engine, batch, base_preds, relabel_rng)

        train_loader.set_epoch(epoch)
        it = iter(train_loader)
        loss_meter = AverageMeter()
        t0 = time.time()
        for i in range(1, steps_per_epoch + 1):
            try:
                batch = next(it)
            except StopIteration:
                it = iter(train_loader)
                batch = next(it)
            metrics = step(episodes_of(batch), batch_generator(seed, epoch, i))
            if i % 10 == 0 or (epoch == 1 and i <= 2):
                m = to_host(metrics)
                iou1 = float((m["inter1"] / (m["union1"] + 1e-10)).mean())
                loss_meter.update(float(m["loss_mean"].mean()))
                if i % 100 == 0 or (epoch == 1 and i <= 2):
                    log(f"Ep{epoch}/{i * cfg.episode_batch} loss {loss_meter.val:.3f} "
                        f"IoU1 {iou1:.3f}")
        log(f"==== Epoch {epoch}: loss {loss_meter.avg:.3f} ({time.time() - t0:.1f}s) ====")

        # validation: binary FG IoU per class of the readout's prediction
        acc_i, acc_u = defaultdict(float), defaultdict(float)
        stream = infinite(val_loader)
        for b, valid_n in enumerate(exact_batch_sizes(cfg.test_num,
                                                      val_loader.batch_size * world)):
            out = to_host(engine.eval_metrics_batch(
                episodes_of(next(stream)), batch_generator(seed, epoch, 7_000_000 + b, rank)))
            accumulate_fg_iou(acc_i, acc_u, out, suffix="1", limit=valid_n)
        miou = fg_miou(acc_i, acc_u)
        log(f"val: mIoU {miou:.4f}")
        if miou > best:
            best = miou
            if cfg.save_models and is_main_process():
                save_ckpt(os.path.join(sv_path, "best.pt"), engine.head.state_dict())
        log(f"=> best mIoU {best:.3f}")
        if cfg.save_models:
            rng = dropout_rng_state(engine.device)
            state = with_rank_states(pack_train_state(engine.head, optimizer, rng, epoch, best,
                                                      scheduler=scheduler), rng)
            if is_main_process():
                save_ckpt(state_path, state)
        barrier()   # rank 0's files are whole before any rank reads them
        check_replicas(engine.head)
        stop_after = cfg.get("stop_after_epochs")
        if stop_after and epoch - start_epoch + 1 >= int(stop_after):
            log(f"=> stop_after_epochs={stop_after}: exiting after epoch {epoch}")
            break
    barrier()
    return best


if __name__ == "__main__":
    main(parse_args("incremental CCA trainer (PyTorch/CUDA)"))
    shutdown()
