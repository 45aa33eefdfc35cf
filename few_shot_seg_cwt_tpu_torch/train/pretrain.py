"""Stage-1 base-class pretraining of the PSPNet, on the GPU.

Counterpart of ``few_shot_seg_cwt_tpu.train.pretrain`` (reference:
src/pretrain.py):

    python -m few_shot_seg_cwt_tpu_torch.train.pretrain --config configs/pascal_pretrain.yaml \
        --opts data_root <VOC2012 tree> [synthetic_data True epochs 1]

* Two parameter groups: the trunk (``layer0``-``layer4``) at ``lr``; the
  PPM, bottleneck, classifier and ``gamma`` at ``lr * scale_lr``. SGD with
  the config's momentum, Nesterov and weight decay, each group on its own
  schedule (cosine by default) stepped per iteration. A parameter that a
  step leaves without a gradient (``gamma``) gets a zero one, so weight
  decay moves it as optax's ``add_decayed_weights`` does.
* The step runs the model in train mode: BN normalises with the batch's
  statistics and updates its running ones as flax does
  (``models.resnet.BatchNorm2d``), and the bottleneck's channel dropout
  draws from the step's generator. Loss: the label-smoothing CE (``smoothing``,
  eps 0.1) or plain CE; with ``mixup``, lambda ~ Beta(0.2, 0.2) and a
  permutation of the batch mix the images and the loss is lambda CE(gt) +
  (1 - lambda) CE(gt[perm]). The train I/U is the mixed logits' against
  the unmixed labels, as the reference logs it.
* Validation after each epoch: pixel mIoU over the val list at train-class
  indexing (``standard_validate``), or with ``episodic_val`` the episodic
  protocol on the adapted inner-loop classifier (``eval.validate.
  episodic_validate``, K1 on the card) through a 2-class ``EpisodicEngine``
  on the live backbone, in eval mode.
* Checkpoints under ``./results/pretrain_<train_name>/<arch><layers>/
  split<s>_shot<shot>/<exp_name>`` with ``save_models``: ``best.ckpt`` (the
  PSPNet's state_dict, at the best validation mIoU) and ``final.ckpt``,
  which ``train.common.load_backbone_weights`` reads as it reads a
  reference ``.pth``; ``train_state.ckpt`` every epoch (model with its BN
  statistics, optimizer, schedule position, the step generator's state,
  epoch and best), read back by ``resume_ckpt`` or ``auto_resume``;
  ``stop_after_epochs`` ends a run early.

Records come from ``data.episodic.StandardDataset`` on the train and val
lists, or with ``synthetic_data`` from seeded random images and labels.
The backbone trains in fp32 whatever ``compute_dtype`` says (the JAX step
casts nothing); uniform bf16 reaches only the episodic validation's
engine. ``pretrained`` ImageNet trunks are not read (nor does the JAX
package read them). The lines go to ``log`` and ``<sv_path>/log.txt``; the
epoch's ``train_loss`` and ``mean_iou/val`` to TensorBoard scalars under
``<sv_path>/model`` (``utils.tb``: an events file, or ``scalars.jsonl``
without ``tensorboard``). Not ported: a mixed ``bf16_stages`` policy.

Over several cards (``torchrun --nproc_per_node N -m
few_shot_seg_cwt_tpu_torch.train.pretrain ...``, ``parallel.mesh``) every
rank takes ``batch_size / N`` records of each global batch by a
rank-strided index stream over one shuffle (the JAX trainer's loaders),
BN normalises over the global batch (``models.resnet.BatchNorm2d``), the
losses are the global batch's means (each rank's pixel sums over the
global valid-pixel count), mixup's lambda and permutation are the global
batch's, drawn alike on every rank, with the partner images gathered from
the other ranks, the gradients are averaged, validation sums the ranks'
I/U, and rank 0 alone writes the log, the scalars and the checkpoints.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import parse_args
from ..data.episodic import StandardDataset
from ..data.loader import EpisodeLoader
from ..episodic.engine import EpisodicEngine
from ..eval.validate import episodic_validate
from ..models.pspnet import PSPNet, build_pspnet, policy_is_noop, stage_dtype_policy
from ..ops.losses import cross_entropy, smoothed_cross_entropy
from ..ops.metrics import intersection_and_union
from ..parallel.mesh import (active, all_reduce_grads, all_reduce_sum, barrier,
                             broadcast_module, check_replicas, distributed_init, gather_rows,
                             is_main_process, rank_world, shutdown)
from ..utils.ckpt import is_full_train_state, load_ckpt, pack_train_state, save_ckpt
from ..utils.logging import get_logger, log_to
from ..utils.meters import AverageMeter
from .common import (apply_debug, episodic_val_loader, fp32_parity, local_batch,
                     maybe_auto_resume, rank_rng_state, set_seeds, with_rank_states)
from ..utils.tb import SummaryWriter
from .optim import build_lr_schedule

TRUNK = ("layer0", "layer1", "layer2", "layer3", "layer4")


def param_groups(model: PSPNet, cfg) -> List[Dict]:
    """The trunk at ``lr``; everything else (PPM, bottleneck, classifier,
    ``gamma``) at ``lr * scale_lr`` (reference src/pretrain.py:68-76)."""
    trunk, new = [], []
    for name, p in model.named_parameters():
        (trunk if name.split(".")[0] in TRUNK else new).append(p)
    return [{"params": trunk, "lr": float(cfg.lr)},
            {"params": new, "lr": float(cfg.lr) * float(cfg.scale_lr)}]


def build_pretrain_optimizer(model: PSPNet, cfg, iters_per_epoch: int
                             ) -> Tuple[torch.optim.SGD, torch.optim.lr_scheduler.LambdaLR]:
    """(SGD over ``param_groups``, a per-iteration scheduler with each
    group's own schedule): the JAX ``param_group_optimizer``."""
    groups = param_groups(model, cfg)
    opt = torch.optim.SGD(groups, lr=groups[0]["lr"], momentum=cfg.momentum,
                          weight_decay=cfg.weight_decay, nesterov=cfg.nesterov)

    def factor(base_lr: float) -> Callable[[int], float]:
        schedule = build_lr_schedule(cfg, base_lr, iters_per_epoch)
        return (lambda step: schedule(step) / base_lr) if base_lr else (lambda step: 1.0)

    return opt, torch.optim.lr_scheduler.LambdaLR(opt, [factor(g["lr"]) for g in groups])


def _beta(generator: torch.Generator, a: float = 0.2) -> float:
    """One Beta(a, a) draw, from a seed that ``generator`` draws."""
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))
    return float(np.random.default_rng(seed).beta(a, a))


def make_pretrain_step(model: PSPNet, optimizer: torch.optim.Optimizer, scheduler, cfg):
    """step(img, gt, generator=None, lam=None, perm=None) -> metrics: one
    SGD step on the whole PSPNet. ``img`` (B, H, W, 3) and ``gt`` (B, H', W')
    on the model's device. Under ``mixup`` lambda and the permutation come
    from ``generator`` unless given; the dropout mask always does (no
    generator is needed at ``dropout 0``). ``metrics``: ``loss`` and the
    (C,) train ``inter``, ``union`` and ``target`` areas.

    Under a process group ``img`` and ``gt`` are this rank's slice of the
    global batch (B a rank): the permutation (``perm``) is over the global
    batch and the partners come from every rank (``gather_rows``), each
    loss term is this rank's pixel sum over the global valid count times
    the world size (so the averaged gradients are the global mean's), the
    gradients are averaged before the update, and ``metrics`` are the
    global batch's."""
    num_classes = int(cfg.num_classes_tr)
    smoothing = 0.1 if cfg.smoothing else 0.0
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def ce(logits, target):
        if smoothing > 0:
            return smoothed_cross_entropy(logits, target, num_classes, smoothing)
        return cross_entropy(logits, target)

    def shares(*targets):
        """Per target: this rank's valid pixels times the world size over the
        global count (1 without a group), turning a local mean into this
        rank's part of the global one."""
        if not active():
            return [1.0] * len(targets)
        world = rank_world()[1]
        local = torch.stack([(t != 255).sum() for t in targets]).double()
        total = all_reduce_sum(local)
        return [local[i] * world / total[i].clamp(min=1) for i in range(len(targets))]

    def step(img, gt, generator: Optional[torch.Generator] = None,
             lam: Optional[float] = None, perm: Optional[torch.Tensor] = None):
        rank, world = rank_world()
        model.train()
        optimizer.zero_grad(set_to_none=True)
        if cfg.mixup:
            b = img.shape[0]
            lam = _beta(generator) if lam is None else float(lam)
            if perm is None:
                perm = torch.randperm(b * world, generator=generator)
            perm = torch.as_tensor(perm).to(img.device)
            if active():
                mine = perm[rank * b:(rank + 1) * b]
                partner_img, partner_gt = gather_rows(img)[mine], gather_rows(gt)[mine]
            else:
                partner_img, partner_gt = img[perm], gt[perm]
            logits = model(lam * img + (1.0 - lam) * partner_img, generator)
            s_gt, s_partner = shares(gt, partner_gt)
            loss = (lam * ce(logits, gt) * s_gt
                    + (1.0 - lam) * ce(logits, partner_gt) * s_partner)
        else:
            logits = model(img, generator)
            loss = ce(logits, gt) * shares(gt)[0]
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        all_reduce_grads(params)
        optimizer.step()
        scheduler.step()
        with torch.no_grad():
            inter, union, target = intersection_and_union(logits.argmax(-1), gt, num_classes)
            metrics = {"loss": loss.detach().float(), "inter": inter.sum(0),
                       "union": union.sum(0), "target": target.sum(0)}
            if active():
                metrics = _global_metrics(metrics, world)
        return metrics

    return step


def _global_metrics(metrics: Dict[str, torch.Tensor], world: int) -> Dict[str, torch.Tensor]:
    """A step's metrics over every rank: the mean of the ranks' losses (each
    a share of the global mean, so this is the global batch's loss) and the
    sums of their areas; one all-reduce in float64 (exact pixel counts)."""
    keys = ("inter", "union", "target")
    flat = torch.cat([metrics["loss"].reshape(1)] + [metrics[k] for k in keys]).double()
    total = all_reduce_sum(flat)
    c = metrics["inter"].numel()
    out = {"loss": (total[0] / world).float()}
    for i, k in enumerate(keys):
        out[k] = total[1 + i * c:1 + (i + 1) * c].float()
    return out


@torch.no_grad()
def standard_eval(model: PSPNet, img, gt, num_classes: int):
    """One val batch in the model's current mode: (C,) inter and union
    areas and the batch's CE."""
    logits = model(img)
    inter, union, _ = intersection_and_union(logits.argmax(-1), gt, num_classes)
    return inter.sum(0), union.sum(0), cross_entropy(logits, gt)


def standard_validate(cfg, model: PSPNet, loader, log=print) -> Tuple[float, float]:
    """Pixel mIoU over the val list at train-class indexing (reference
    src/pretrain.py:222-249), in eval mode; the model's mode is restored
    after. Returns (mIoU, mean batch loss). Under a process group ``loader``
    is this rank's rank-strided slice, and the I/U sums and the batch losses
    are summed over the ranks before scoring, so every rank gets the same
    mIoU (the loss is the mean of the ranks' batch means)."""
    was_training = model.training
    model.eval()
    inters = np.zeros(cfg.num_classes_tr)
    unions = np.zeros(cfg.num_classes_tr)
    loss_meter = AverageMeter()
    try:
        for batch in loader:
            inter, union, loss = standard_eval(model, batch["img"], batch["label"],
                                               int(cfg.num_classes_tr))
            inters += inter.cpu().numpy()
            unions += union.cpu().numpy()
            loss_meter.update(float(loss))
    finally:
        model.train(was_training)
    if active():
        total = all_reduce_sum(torch.from_numpy(np.concatenate(
            [inters, unions, [loss_meter.sum, loss_meter.count]])))
        c = len(inters)
        inters, unions = total[:c].numpy(), total[c:2 * c].numpy()
        loss_meter.avg = float(total[-2] / max(float(total[-1]), 1.0))
    miou = float((inters / (unions + 1e-10)).mean())
    acc = float(inters.sum() / max(unions.sum(), 1e-10))
    log(f"Testing results: running loss {loss_meter.avg:.2f}, Acc {acc:.4f}, mIoU {miou:.4f}")
    return miou, loss_meter.avg


def run_episodic_validation(cfg, model: PSPNet, loader, device, log=print) -> Tuple[float, float]:
    """``episodic_validate`` through a 2-class ``EpisodicEngine`` on the live
    backbone (a cast copy under a bf16 policy, which the engine would
    otherwise apply in place); the model's mode and trainability are
    restored after."""
    ep_cfg = cfg.clone()
    ep_cfg.num_classes_tr = 2   # a fresh binary classifier (src/test.py:309)
    policy = stage_dtype_policy(ep_cfg)
    backbone = model if policy_is_noop(policy) else copy.deepcopy(model)
    was_training = model.training
    try:
        engine = EpisodicEngine(ep_cfg, backbone=backbone, device=device)
        return episodic_validate(ep_cfg, engine, loader, log=log)
    finally:
        model.requires_grad_(True)
        model.train(was_training)


class SyntheticRecords:
    """Seeded random multi-class records (the JAX trainer's synthetic set):
    record i of a set of n is drawn from ``default_rng(7 n + i)``."""

    def __init__(self, n: int, size: int, num_classes: int):
        self.n, self.size, self.num_classes = n, size, num_classes

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        r = np.random.default_rng(7 * self.n + i)
        img = r.normal(0, 0.5, (self.size, self.size, 3)).astype(np.float32)
        lab = r.integers(0, self.num_classes, (self.size, self.size)).astype(np.int32)
        return {"img": img, "label": lab}


def save_dir(cfg) -> str:
    return os.path.join("./results", f"pretrain_{cfg.train_name}", f"{cfg.arch}{cfg.layers}",
                        f"split{cfg.train_split}_shot{cfg.shot}", str(cfg.exp_name))


def _check_supported(cfg) -> None:
    if len(set(stage_dtype_policy(cfg).values())) > 1:
        raise NotImplementedError(
            f"bf16_stages {cfg.bf16_stages!r}: pretraining runs the backbone in fp32 "
            "(a mixed stage policy is not ported)")


def main(cfg, device="cuda", log=print) -> float:
    """Pretrain the PSPNet for ``epochs`` epochs; returns the best validation
    mIoU. ``log`` receives every line, and ``<sv_path>/log.txt`` gets them
    too from the moment the run's directory is known; the epoch's
    ``train_loss`` and ``mean_iou/val`` go to TensorBoard scalars under
    ``<sv_path>/model`` (``utils.tb``)."""
    device = distributed_init(cfg, device=device)
    log_to(None)   # no tee until this run's directory is known
    log = get_logger(log)
    fp32_parity()
    _check_supported(cfg)
    log(cfg)
    set_seeds(cfg)
    apply_debug(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("pretrain: no CUDA device; pass device='cpu'")

    fp32_cfg = cfg.clone()
    fp32_cfg.compute_dtype, fp32_cfg.use_amp, fp32_cfg.bf16_stages = "float32", False, None
    model = build_pspnet(fp32_cfg).to(device)

    if cfg.get("synthetic_data"):
        size, k = int(cfg.image_size), int(cfg.num_classes_tr)
        train_ds, val_ds = SyntheticRecords(64, size, k), SyntheticRecords(16, size, k)
    else:
        train_ds, val_ds = StandardDataset(cfg, train=True), StandardDataset(cfg, train=False)
    seed = int(cfg.manual_seed or 0)
    # every rank shuffles with the same seed and takes a rank-strided slice,
    # so the ranks' slices make up the one-process batches (the JAX loaders)
    rank, world = rank_world()
    batch = local_batch(int(cfg.batch_size))
    train_loader = EpisodeLoader(train_ds, batch_size=batch, shuffle=True,
                                 num_workers=cfg.workers, seed=seed, device=device,
                                 rank=rank, world=world)
    episodic = bool(cfg.get("episodic_val", False))
    val_loader = (episodic_val_loader(cfg, device=device) if episodic else
                  EpisodeLoader(val_ds, batch_size=batch, shuffle=False,
                                num_workers=cfg.workers, drop_last=False, device=device,
                                rank=rank, world=world))

    optimizer, scheduler = build_pretrain_optimizer(model, cfg, len(train_loader))
    step = make_pretrain_step(model, optimizer, scheduler, cfg)
    generator = torch.Generator().manual_seed(seed)
    sv_path = save_dir(cfg)
    log_to(sv_path)
    writer = SummaryWriter(os.path.join(sv_path, "model")) if is_main_process() else None
    state_path = os.path.join(sv_path, "train_state.ckpt")

    start_epoch, best = 0, 0.0
    maybe_auto_resume(cfg, state_path, log)
    if cfg.get("resume_ckpt"):
        path = str(cfg.resume_ckpt)
        if is_full_train_state(path):
            state = load_ckpt(path)
            model.load_state_dict(state["model"])
            optimizer.load_state_dict(state["optimizer"])
            scheduler.load_state_dict(state["scheduler"])
            generator.set_state(rank_rng_state(state))
            start_epoch, best = int(state["meta"]["epoch"]), float(state["meta"]["best"])
            log(f"=> resumed full pretrain state at epoch {start_epoch} (best {best:.3f})")
        else:
            model.load_state_dict(load_ckpt(path))
            log(f"=> resumed pretrain weights from {path}")
    broadcast_module(model)

    log("==> Start training")
    for epoch in range(start_epoch, cfg.epochs):
        train_loader.set_epoch(epoch)
        loss_meter = AverageMeter()
        t0 = time.time()
        for i, batch in enumerate(train_loader, start=1):
            metrics = step(batch["img"], batch["label"], generator)
            if i % cfg.log_freq == 0:
                m = {k: v.cpu().numpy() for k, v in metrics.items()}
                miou = float((m["inter"] / (m["union"] + 1e-10)).mean())
                loss_meter.update(float(m["loss"]))
                log(f"iter {i}/{epoch}: loss {float(m['loss']):.2f}, "
                    f"running loss {loss_meter.avg:.2f}, mIoU {miou:.4f}")
        log(f"===== Epoch {epoch}: running loss {loss_meter.avg:.2f} "
            f"({time.time() - t0:.1f}s) =====")
        if writer is not None:
            writer.add_scalar("train_loss", loss_meter.avg, epoch)

        if episodic:
            val_miou, _ = run_episodic_validation(cfg, model, val_loader, device, log)
        else:
            val_miou, _ = standard_validate(cfg, model, val_loader, log)
        if writer is not None:
            writer.add_scalar("mean_iou/val", val_miou, epoch)

        if val_miou > best:
            best = val_miou
            if cfg.save_models and is_main_process():
                path = os.path.join(sv_path, "best.ckpt")
                log(f"=> Max_mIoU = {best:.3f}, saving to {path}")
                save_ckpt(path, model.state_dict())
        if cfg.save_models:
            rng = generator.get_state()
            state = with_rank_states(pack_train_state(model, optimizer, rng, epoch + 1, best,
                                                      scheduler=scheduler), rng)
            if is_main_process():
                save_ckpt(state_path, state)
        barrier()   # rank 0's files are whole before any rank reads them
        check_replicas(model, generator.get_state())
        stop_after = cfg.get("stop_after_epochs")
        if stop_after and epoch - start_epoch + 1 >= int(stop_after):
            log(f"=> stop_after_epochs={stop_after}: exiting after epoch {epoch}")
            break

    if cfg.save_models and is_main_process():
        save_ckpt(os.path.join(sv_path, "final.ckpt"), model.state_dict())
    if writer is not None:
        writer.close()
    barrier()
    return best


if __name__ == "__main__":
    main(parse_args("Stage-1 base pretraining (PyTorch/CUDA)"))
    shutdown()
