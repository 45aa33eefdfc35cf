"""Data-parallel dry run: the train steps over N processes against one process.

Counterpart of ``__graft_entry__.py:dryrun_multichip`` inside the port::

    python -m few_shot_seg_cwt_tpu_torch.parallel.dryrun --world 2 --backend gloo --device cpu

It starts the processes itself (one command, no ``torchrun``), each from
this module, so no caller's modules are imported in them:

* a reference process runs every step on the whole global batch twice:
  first without a process group (the single-process path, ``plain``), then
  in a process group of one over the world-1 backend (NCCL on a card, gloo
  on the CPU), so that the collective code path runs on any card count;
* N rank processes in one group (``--backend``; on the card one rank a
  card, or, with fewer cards than ranks, every rank on ``cuda:0`` over gloo,
  named explicitly, since NCCL refuses two ranks on one card) each run the
  steps on their slice of the same global batch.

The steps (``--checks``): ``cwt``, the CWT meta-train step with every
dropout off at each ``FSS_INNER_TILE`` of ``tiles`` (K1 at 1, K2 at 2);
``mmn``, the MMN head's train step (head dropout off) with the head in
fp32 and, where the config sets ``use_amp``, in bf16; ``pretrain``, the
stage-1 step with live BN (dropout and mixup as the spec says), beside the
reference's rerun on the batch permuted (the JAX package's
self-calibrating bar, tests/test_parallel.py); ``eval``, the gathered
per-episode metrics of one eval batch against one process's run with each
rank's inits; ``validate``, ``validate_transformer`` and
``episodic_validate`` over ``episode_batch`` episodes a batch; ``trainers``,
``train_cwt.main`` and ``train_head.main`` (the ``train_ddp`` path) whole,
cut after one epoch and resumed, and ``pretrain.main``, in a scratch
directory, with the files each rank wrote.

Every check prints one JSON line with its error against its limit, the
ranks' launches of each kernel beside the reference's, each step's ms and
peak GiB per rank and the gradient all-reduce's ms and bytes; the command
exits with 3 when a check fails (1 when a process fails). A spec file (``--spec``, ``torch.save``
of a dict; see ``default_spec``) sets the sizes, configs, weights and
explicit inits; every result is also saved under ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

CHECKS = ("cwt", "mmn", "pretrain", "eval", "validate", "collectives", "trainers")
KERNELS = ("adapt_binary", "adapt_binary_tiled", "pivot_fwd", "pivot_dw")
PIVOT_SWITCHES = ("FSS_PIVOT_MXU", "FSS_PIVOT_PALLAS", "FSS_DISABLE_PALLAS", "FSS_NCONS_R4")
TILES = (1, 2)   # FSS_INNER_TILE of the CWT step: K1, then K2
LR = 0.01        # the CWT and MMN steps' SGD rate


def default_spec(size: int = 473, adapt_iter: int = 200, checks=CHECKS[:6]) -> Dict:
    """The steps at the width of configs/pascal.yaml, pascal_mmn.yaml (as
    shipped: ``use_amp``, 2 episodes a step, the flat route) and
    pascal_pretrain.yaml (batch 10), from seeded weights and batches. Below
    473 px the MMN step trains ``wt_ce``: the config's ``wt_dc`` saturates
    on small random inputs (exactly zero head gradients at 33 px)."""
    common = ["image_size", str(size), "adapt_iter", str(adapt_iter)]
    mmn_opts = common + (["loss_type", "wt_ce"] if size < 473 else [])
    return {
        "seed": 7, "checks": list(checks),
        "cwt": {"config": "configs/pascal.yaml", "opts": common + ["cls_lr", "0.1"],
                "episodes": 8, "weights": None, "w0": None},
        "mmn": {"config": "configs/pascal_mmn.yaml", "opts": mmn_opts, "episodes": 2,
                "shots": [1], "weights": None, "w0": None},
        "pretrain": {"config": "configs/pascal_pretrain.yaml", "opts": ["image_size", str(size)],
                     "batch": 10, "dtype": "float32", "mixup": False, "weights": None,
                     "lam": None, "perm": None},
        "eval": {"config": "configs/pascal.yaml", "opts": common + ["cls_lr", "0.1"],
                 "episodes": 8},
        "validate": {"config": "configs/pascal.yaml", "opts": common + ["cls_lr", "0.1"],
                     "episodes": 4, "test_num": 8},
        "trainers": {"size": 33, "dir": None},
    }


# --------------------------------------------------------------------------- #
# helpers run in every process
# --------------------------------------------------------------------------- #


@contextlib.contextmanager
def _env(**values):
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _cfg(part: Dict, *extra: str):
    from ..config import load_cfg, merge_cfg_from_list

    return merge_cfg_from_list(load_cfg(part["config"]), list(part["opts"]) + list(extra))


def _launches() -> Dict[str, int]:
    from ..ops import cuda_inner_loop, cuda_pivot

    return {k: int(v) for k, v in {**cuda_inner_loop.LAUNCHES, **cuda_pivot.LAUNCHES}.items()
            if k in KERNELS}


def _reset_launches() -> None:
    from ..ops import cuda_inner_loop, cuda_pivot

    cuda_inner_loop.reset_launches()
    cuda_pivot.reset_launches()


def _shard(tree, rank: int, world: int):
    """Rank's rows of every leading axis (the global batch's slice)."""
    def one(v):
        n = v.shape[0] // world
        return v[rank * n:(rank + 1) * n]
    return {k: one(v) for k, v in tree.items()}


def _host32(named) -> Dict[str, torch.Tensor]:
    """float32 host copies of floating tensors (the comparisons' data: the
    steps may compute in float64, and their rounding to float32 here is
    far below every limit), others as they are."""
    return {k: (v.detach().to("cpu", torch.float32, copy=True) if v.is_floating_point()
                else v.detach().to("cpu", copy=True)) for k, v in named}


def _digests(named) -> Dict[str, str]:
    """sha1 of each tensor's bytes: equal digests are equal bits."""
    return {k: hashlib.sha1(v.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                            .numpy().tobytes()).hexdigest() for k, v in named}


def _timed(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def _allreduce_cost(params, device) -> Dict:
    """ms of one gradient all-reduce (median of 3, on gradients already
    equal on every rank) and its bytes; zeros without a group."""
    from .mesh import active, all_reduce_grads

    if not active():
        return {"allreduce_ms": 0.0, "allreduce_bytes": 0}
    params = list(params)
    times, nbytes = [], 0
    for _ in range(3):
        nbytes, ms = _timed(lambda: all_reduce_grads(params), device)
        times.append(ms)
    return {"allreduce_ms": float(np.median(times)), "allreduce_bytes": int(nbytes)}


def _step_record(fn, module, device, keep: bool) -> Dict:
    """Run one step ``fn`` with the launch counts reset around it: its
    metrics, ms and launches, the digests of ``module``'s parameters and
    buffers after it, and with ``keep`` the gradients it left."""
    _reset_launches()
    metrics, ms = _timed(fn, device)
    named = list(module.named_parameters())
    rec = {"metrics": {k: v.detach().cpu() for k, v in metrics.items()}, "ms": ms,
           "launches": _launches(),
           "digests": _digests(named + list(module.named_buffers()))}
    if keep:
        rec["grads"] = _host32((k, p.grad) for k, p in named if p.grad is not None)
    return rec


# --------------------------------------------------------------------------- #
# the steps
# --------------------------------------------------------------------------- #


def run_cwt(part: Dict, seed: int, device, rank: int, world: int, keep: bool) -> Dict:
    from ..data.synthetic import make_episode_batch
    from ..episodic.engine import EpisodicEngine

    e = int(part["episodes"])
    cfg = _cfg(part, "episode_batch", str(e), "dropout", "0.0")
    engine = EpisodicEngine(cfg, device=device)
    if part.get("weights"):
        engine.backbone.load_state_dict(part["weights"]["backbone"])
        engine.cwt.load_state_dict(part["weights"]["cwt"])
    engine.cwt.dropout = engine.cwt.attn_dropout = 0.0
    start = copy.deepcopy(engine.cwt.state_dict())
    episodes = _shard(make_episode_batch(seed, e, size=int(cfg.image_size)), rank, world)
    w0 = None if part.get("w0") is None else _shard({"w": part["w0"]}, rank, world)["w"]
    out = {}
    for tile in TILES:
        engine.cwt.load_state_dict(start)
        opt = torch.optim.SGD(engine.cwt.parameters(), lr=LR)
        step = engine.make_train_step(opt)
        with _env(FSS_INNER_TILE=tile):
            rec = _step_record(lambda: step(episodes, torch.Generator().manual_seed(seed), w0),
                               engine.cwt, device, keep)
            rec.update(_allreduce_cost(engine.cwt.parameters(), device))
            _, rec["warm_ms"] = _timed(
                lambda: step(episodes, torch.Generator().manual_seed(seed), w0), device)
        out[f"tile{tile}"] = rec
    return out


def run_mmn(part: Dict, seed: int, device, rank: int, world: int, keep: bool,
            n_ranks: int) -> Dict:
    """The MMN step at each shot count of ``shots`` (``w0`` and the episodes'
    seed by shot)."""
    return {shot: run_mmn_shot(part, shot, seed, device, rank, world, keep, n_ranks)
            for shot in part.get("shots", [1])}


def _split_grads(engine, episodes: Dict, w0: torch.Tensor, n: int) -> Dict:
    """One process's MMN gradients with the global batch's prologue run in
    the ranks' slices (each slice's backbone pass and inner loop on its own,
    as n ranks run them), averaged: the step of n ranks without any
    collective."""
    total = None
    for r in range(n):
        engine.backward_batch(_shard(episodes, r, n), w0=_shard({"w": w0}, r, n)["w"])
        grads = {k: p.grad.detach().clone() for k, p in engine.head.named_parameters()
                 if p.grad is not None}
        total = grads if total is None else {k: total[k] + g for k, g in grads.items()}
    return _host32((k, g / n) for k, g in total.items())


def run_mmn_shot(part: Dict, shot: int, seed: int, device, rank: int, world: int,
                 keep: bool, n_ranks: int) -> Dict:
    """The MMN step of the config (head dropout off) with the head in fp32
    and, where the config sets ``use_amp`` (a bf16 backbone), in bf16. The
    backbone's results depend on the batch it runs (cuDNN picks its
    algorithm by shape, and the head's gradients amplify the difference),
    so one process alone (world 1 of ``n_ranks``) also gives the gradients
    of the ranks' slices run one after another (``split_grads``)."""
    from ..data.synthetic import make_episode_batch
    from ..episodic.heads import HeadEngine

    e = int(part["episodes"])
    cfg = _cfg(part, "episode_batch", str(e), "att_drop", "0.0", "proj_drop", "0.0",
               "shot", str(shot))
    flat = {k: None for k in PIVOT_SWITCHES}
    flat["FSS_PIVOT_MXU"] = "1"   # the flat route: the pivot kernels
    episodes = make_episode_batch(seed + shot, e, size=int(cfg.image_size), shot=shot)
    if shot > 1:
        episodes["s_label"][0, -1] = 255   # a padded shot
    w0 = (part.get("w0") or {}).get(shot)
    local = _shard(episodes, rank, world)
    w0_local = None if w0 is None else _shard({"w": w0}, rank, world)["w"]
    out = {}
    with _env(**flat):
        engine = HeadEngine(cfg, "mmn", device=device)
        if part.get("weights"):
            engine.backbone.load_state_dict(part["weights"]["backbone"])
            engine.head.load_state_dict(part["weights"]["head"])
        else:
            # a seeded consensus with zero biases can be dead (its last ReLU
            # zeroes every output, and every head gradient is 0)
            with torch.no_grad():
                for name, p in engine.head.named_parameters():
                    if "NeighConsensus" in name and name.endswith("bias"):
                        p.fill_(0.1)
        start = copy.deepcopy(engine.head.state_dict())
        for amp in ([False, True] if cfg.get("use_amp", False) else [False]):
            engine.cfg.use_amp = amp   # fp32 head: use_amp off in the step, the backbone kept
            engine.head.load_state_dict(start)
            opt = torch.optim.SGD(engine.head.parameters(), lr=LR)
            step = engine.make_train_step(opt)
            rec = _step_record(lambda: step(local, torch.Generator().manual_seed(seed),
                                            w0_local), engine.head, device, keep)
            rec.update(_allreduce_cost(engine.head.parameters(), device))
            _, rec["warm_ms"] = _timed(
                lambda: step(local, torch.Generator().manual_seed(seed), w0_local), device)
            if keep and world == 1 and n_ranks > 1:
                engine.head.load_state_dict(start)
                w0_all = (w0 if w0 is not None else
                          engine.init_weights(e, torch.Generator().manual_seed(seed)))
                rec["split_grads"] = _split_grads(engine, episodes, w0_all, n_ranks)
            out["bf16_head" if amp else "fp32_head"] = rec
    return out


def pretrain_batch(part: Dict, seed: int, size: int, classes: int):
    """The global batch of the stage-1 step: N(0, 1) images, labels with a
    band of 255 in the first image."""
    rng = np.random.default_rng(seed)
    b = int(part["batch"])
    img = rng.standard_normal((b, size, size, 3)).astype(np.float32)
    gt = rng.integers(0, classes, (b, size, size)).astype(np.int64)
    gt[0, :size // 6] = 255
    return img, gt


def run_pretrain(part: Dict, seed: int, device, rank: int, world: int, keep: bool,
                 permuted: bool = False) -> Dict:
    """The stage-1 step; with ``keep`` the parameters and BN statistics after
    it, with ``permuted`` also the largest distance of the parameters from
    those of the same step on the batch permuted (``envelope``)."""
    from ..models.pspnet import build_pspnet
    from ..train.pretrain import build_pretrain_optimizer, make_pretrain_step

    cfg = _cfg(part, "dropout", "0.0", "mixup", str(part["mixup"]),
               "compute_dtype", "float32", "use_amp", "False")
    dtype = getattr(torch, part["dtype"])
    model = build_pspnet(cfg).to(device=device, dtype=dtype)
    if part.get("weights"):
        model.load_state_dict(part["weights"])
    start = copy.deepcopy(model.state_dict())
    img, gt = pretrain_batch(part, seed, int(cfg.image_size), int(cfg.num_classes_tr))

    def one(order: Optional[np.ndarray]) -> Dict:
        model.load_state_dict(start)
        opt, sched = build_pretrain_optimizer(model, cfg, 4)
        step = make_pretrain_step(model, opt, sched, cfg)
        i, g = (img, gt) if order is None else (img[order], gt[order])
        batch = _shard({"img": torch.from_numpy(i), "gt": torch.from_numpy(g)}, rank, world)
        x, y = batch["img"].to(device=device, dtype=dtype), batch["gt"].to(device)
        kw = {} if part.get("lam") is None else {"lam": part["lam"], "perm": part["perm"]}
        rec = _step_record(lambda: step(x, y, torch.Generator().manual_seed(seed), **kw),
                           model, device, False)
        rec.update(_allreduce_cost([p for _, p in model.named_parameters()], device))
        return rec

    out = {"step": one(None)}
    after = {k: p.detach().clone() for k, p in model.named_parameters()}
    if keep:
        out["step"]["params"] = _host32(after.items())
        out["step"]["buffers"] = _host32((k, b) for k, b in model.named_buffers()
                                         if k.endswith(("running_mean", "running_var")))
    if permuted:
        out["permuted"] = one(np.random.default_rng(5).permutation(len(img)))
        out["envelope"] = max(float((p - after[k]).abs().max())
                              for k, p in model.named_parameters())
    return out


def _rank_inits(engine, e_local: int, world: int, seed: int, run: int, b: int) -> torch.Tensor:
    """The inits that N ranks draw for batch b of run (``batch_generator``
    with each rank's term), in the gathered order rank after rank."""
    from ..eval.validate import batch_generator

    return torch.cat([engine.init_weights(e_local, batch_generator(seed, run, b, r))
                      for r in range(world)])


def run_eval(part: Dict, seed: int, device, rank: int, world: int, n_ranks: int) -> Dict:
    """One eval batch: each rank scores its slice with its own generator and
    the metrics are gathered; the reference (``n_ranks`` > 1) scores the
    whole batch with the inits each rank drew."""
    from ..data.synthetic import make_episode_batch
    from ..episodic.engine import EpisodicEngine
    from ..eval.validate import batch_generator
    from .mesh import to_host

    e = int(part["episodes"])
    cfg = _cfg(part, "episode_batch", str(e))
    engine = EpisodicEngine(cfg, device=device)
    if part.get("weights"):
        engine.backbone.load_state_dict(part["weights"]["backbone"])
        engine.cwt.load_state_dict(part["weights"]["cwt"])
    episodes = make_episode_batch(seed + 1, e, size=int(cfg.image_size))
    _reset_launches()
    if world > 1:
        local = _shard(episodes, rank, world)
        out, ms = _timed(lambda: to_host(engine.eval_metrics_batch(
            local, batch_generator(seed, 0, 0, rank))), device)
    else:
        w0 = _rank_inits(engine, e // n_ranks, n_ranks, seed, 0, 0)
        out, ms = _timed(lambda: to_host(engine.eval_metrics_batch(episodes, w0=w0)), device)
    return {"metrics": out, "ms": ms, "launches": _launches(),
            "pixels": int(cfg.image_size) ** 2}


class RankInitEngine:
    """One process's engine that scores each batch with the inits N ranks
    would draw for it (``validate_transformer`` and ``episodic_validate``
    pass a generator, which this ignores): a world-1 run of the protocol
    that N ranks run. ``order`` maps the one-process batch's positions to
    the ranks' gathered order (rank-strided loaders)."""

    def __init__(self, engine, n_ranks: int, seed: int, e_global: int, batches_a_run: int):
        self.engine, self.n_ranks, self.seed = engine, n_ranks, seed
        self.e_local = e_global // n_ranks
        self.batches = batches_a_run
        self.device = engine.device
        self.calls = 0
        # one-process position j = r + n_ranks * k is rank r's k-th episode
        self.order = [(j % n_ranks) * self.e_local + j // n_ranks for j in range(e_global)]

    def _w0(self) -> torch.Tensor:
        run, b = divmod(self.calls, self.batches)
        self.calls += 1
        w0 = _rank_inits(self.engine, self.e_local, self.n_ranks, self.seed, run, b)
        return w0[self.order]

    def eval_metrics_batch(self, episodes, generator=None):
        return self.engine.eval_metrics_batch(episodes, w0=self._w0())

    def eval_metrics_batch_no_cwt(self, episodes, generator=None):
        return self.engine.eval_metrics_batch_no_cwt(episodes, w0=self._w0())


def run_validate(part: Dict, seed: int, device, rank: int, world: int, n_ranks: int) -> Dict:
    from ..episodic.engine import EpisodicEngine
    from ..eval.validate import episodic_validate, exact_batch_sizes, validate_transformer
    from ..train.common import episodic_val_loader

    e = int(part["episodes"])
    cfg = _cfg(part, "episode_batch", str(e), "synthetic_data", "True",
               "test_num", str(part["test_num"]), "n_runs", "2", "manual_seed", str(seed))
    cfg.workers = 0
    engine = EpisodicEngine(cfg, device=device)
    if part.get("weights"):
        engine.backbone.load_state_dict(part["weights"]["backbone"])
        engine.cwt.load_state_dict(part["weights"]["cwt"])
    loader = episodic_val_loader(cfg, device=device)
    if world == 1 and n_ranks > 1:
        n_b = len(exact_batch_sizes(int(cfg.test_num), e))
        scorer = lambda: RankInitEngine(engine, n_ranks, seed, e, n_b)  # noqa: E731
    else:
        scorer = lambda: engine  # noqa: E731
    quiet = lambda *_: None  # noqa: E731
    _reset_launches()
    (miou, loss), ms = _timed(lambda: validate_transformer(cfg, scorer(), loader, log=quiet),
                              device)
    ep_miou, ep_loss = episodic_validate(cfg, scorer(), loader, log=quiet)
    return {"miou": miou, "loss": loss, "episodic_miou": ep_miou, "episodic_loss": ep_loss,
            "ms": ms, "launches": _launches()}


def run_trainers(part: Dict, device, rank: int, world: int) -> Dict:
    """``train_cwt.main``, ``train_ddp.main`` (the MMN head trainer) and
    ``pretrain.main`` on synthetic data at ``size`` px, each whole (2 epochs),
    and the first two cut after one epoch and resumed; the files under
    ``dir`` are the caller's to read."""
    from ..config import default_cfg, load_cfg, merge_cfg_from_list
    from ..train import pretrain, train_cwt, train_ddp

    size = str(part["size"])
    work = part["dir"]
    ddp_yaml, pretrain_yaml = (os.path.abspath(f"configs/{n}.yaml")
                               for n in ("pascal_ddp", "pascal_pretrain"))
    quiet = lambda *_: None  # noqa: E731
    out = {}

    def cwt_cfg(name, **opts):
        cfg = merge_cfg_from_list(default_cfg(), [
            "image_size", size, "adapt_iter", "2", "synthetic_data", "True", "epochs", "2",
            "iter_per_epoch", "8", "episode_batch", "4", "test_num", "4", "n_runs", "1",
            "save_models", "True", "model_dir", os.path.join(work, name), "workers", "0"])
        for k, v in opts.items():
            cfg[k] = v
        return cfg

    def head_cfg(name, **opts):
        cfg = merge_cfg_from_list(load_cfg(ddp_yaml), [
            "image_size", size, "adapt_iter", "2", "synthetic_data", "True", "epochs", "2",
            "iter_per_epoch", "4", "episode_batch", "2", "test_num", "2", "save_models", "True",
            "exp_name", name, "workers", "0", "loss_type", "wt_ce"])
        for k, v in opts.items():
            cfg[k] = v
        return cfg

    def run(key, fn, cfg):
        t0 = time.perf_counter()
        out[key] = fn(cfg, device=device, log=quiet)
        out[f"{key}_s"] = time.perf_counter() - t0

    with contextlib.chdir(work):
        run("cwt_whole", train_cwt.main, cwt_cfg("cwt_whole"))
        run("cwt_cut", train_cwt.main, cwt_cfg("cwt_cut", stop_after_epochs=1))
        run("cwt_resumed", train_cwt.main, cwt_cfg("cwt_cut", auto_resume=True))
        run("head_whole", train_ddp.main, head_cfg("whole"))
        run("head_cut", train_ddp.main, head_cfg("cut", stop_after_epochs=1))
        run("head_resumed", train_ddp.main, head_cfg("cut", auto_resume=True))
        run("pretrain", pretrain.main, merge_cfg_from_list(load_cfg(pretrain_yaml), [
            "image_size", size, "synthetic_data", "True", "epochs", "1", "batch_size", "8",
            "num_classes_tr", "4", "save_models", "True", "workers", "0", "exp_name", "ddp"]))
    return out


def run_collectives(seed: int, device, rank: int, world: int, n_ranks: int) -> Dict:
    """``to_host`` of per-rank rows, scalars and flags, and one train-mode
    ``BatchNorm2d`` in float64 on this rank's slice of a global batch
    (``n_ranks`` slices): output, input gradient, the averaged weight and
    bias gradients and the running statistics."""
    from ..models.resnet import BatchNorm2d
    from .mesh import all_reduce_grads, to_host

    rows = torch.arange(6, dtype=torch.int64, device=device).reshape(2, 3) + 100 * rank
    gathered = to_host({"rows": rows, "scalar": torch.tensor(float(rank), device=device),
                        "flag": torch.tensor([rank % 2 == 0], device=device)})
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(3.0, 2.0, (2 * n_ranks, 8, 5, 5)))
    dy = torch.from_numpy(rng.normal(0.0, 1.0, x.shape))
    bn = BatchNorm2d(8).double().to(device)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 8)))
        bn.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.1, 8)))
    bn.train()
    n = x.shape[0] // world
    xs = x[rank * n:(rank + 1) * n].to(device).requires_grad_(True)
    y = bn(xs)
    (y * dy[rank * n:(rank + 1) * n].to(device)).sum().backward()
    all_reduce_grads(bn.parameters())
    return {"gathered": gathered, "bn": {
        "y": to_host(y.detach()), "dx": to_host(xs.grad),
        "dw": bn.weight.grad.cpu() * world, "db": bn.bias.grad.cpu() * world,
        "running_mean": bn.running_mean.cpu(), "running_var": bn.running_var.cpu()}}


def run_steps(spec: Dict, device, n_ranks: int, reference: bool) -> Dict:
    """Every check of ``spec`` in this process, as its rank of the current
    group (or alone without one); ``reference`` adds the permuted rerun of
    the pretrain step."""
    from .mesh import rank_world

    rank, world = rank_world()
    seed = int(spec["seed"])
    out: Dict = {"rank": rank, "world": world}
    checks = spec["checks"]
    keep = rank == 0   # the others' steps are held by their digests
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if "cwt" in checks:
        out["cwt"] = run_cwt(spec["cwt"], seed, device, rank, world, keep)
    if "mmn" in checks:
        out["mmn"] = run_mmn(spec["mmn"], seed, device, rank, world, keep, n_ranks)
    if "pretrain" in checks:
        out["pretrain"] = run_pretrain(spec["pretrain"], seed, device, rank, world, keep,
                                       permuted=reference)
    if "eval" in checks:
        out["eval"] = run_eval(spec["eval"], seed, device, rank, world, n_ranks)
    if "validate" in checks:
        out["validate"] = run_validate(spec["validate"], seed, device, rank, world, n_ranks)
    if "collectives" in checks:
        out["collectives"] = run_collectives(seed, device, rank, world, n_ranks)
    if "trainers" in checks and world > 1:
        out["trainers"] = run_trainers(spec["trainers"], device, rank, world)
    out["peak_gib"] = (torch.cuda.max_memory_allocated(device) / 2**30
                       if device.type == "cuda" else None)
    return out


def worker(args) -> None:
    """One process: the reference (plain, then a group of one) or a rank."""
    from ..ops import cuda_build, cuda_inner_loop, cuda_pivot
    from ..train.common import fp32_parity
    from .mesh import distributed_init, shutdown

    torch.set_num_threads(max(1, int(args.threads)))
    fp32_parity()
    spec = torch.load(args.spec, map_location="cpu", weights_only=False)
    device = torch.device(args.rank_device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        cuda_build.build([cuda_inner_loop.build_spec(), cuda_pivot.build_spec()])
    init = f"file://{os.path.abspath(args.store)}"
    results = {}
    if args.role == "reference":
        results["plain"] = run_steps(spec, device, args.n_ranks, False)
    device = distributed_init(None, backend=args.backend, device=device, init_method=init)
    key = "world1" if args.role == "reference" else "rank"
    results[key] = run_steps(spec, device, args.n_ranks, args.role == "reference")
    torch.save(results, args.result)
    shutdown()


# --------------------------------------------------------------------------- #
# the launcher and the comparisons
# --------------------------------------------------------------------------- #


def _start(world: int, backend: str, devices: List[str], role: str, spec_path: str,
           work: str, n_ranks: int, threads: int) -> List:
    """Start the ``world`` processes of one group (one ``role``)."""
    store = os.path.join(work, f"store_{role}_{world}")
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r))
        result = os.path.join(work, f"{role}_{r}.pt")
        cmd = [sys.executable, "-m", "few_shot_seg_cwt_tpu_torch.parallel.dryrun", "--worker",
               "--role", role, "--spec", spec_path, "--store", store, "--result", result,
               "--backend", backend, "--rank-device", devices[r], "--n-ranks", str(n_ranks),
               "--threads", str(threads)]
        log = open(os.path.join(work, f"{role}_{r}.log"), "w")
        procs.append((role, r, subprocess.Popen(cmd, env=env, stdout=log,
                                                stderr=subprocess.STDOUT), log, result))
    return procs


def _wait(procs: List, timeout: float) -> List[Dict]:
    """Wait for every process (killing what outlives ``timeout``); raise
    with the end of each failed process's log, else load their results."""
    deadline = time.monotonic() + timeout
    failed = []
    for role, r, p, log, _ in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        if p.returncode != 0:
            with open(log.name) as f:
                failed.append(f"{role} rank {r} exited {p.returncode}:\n{f.read()[-4000:]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return [torch.load(res, map_location="cpu", weights_only=False) for *_, res in procs]


def _max_rel(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]):
    """The worst max|got - want| / max|want| over the tensors, and its name."""
    worst = (0.0, "")
    for k, w in want.items():
        scale = float(w.double().abs().max())
        err = float((got[k].double() - w.double()).abs().max()) / max(scale, 1e-30)
        worst = max(worst, (err, k))
    return worst


def _max_abs(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> float:
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in b)


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).norm() / max(float(want.double().norm()), 1e-30))


def _ranks_equal(ranks: List[Dict], path) -> bool:
    """Equal parameters and buffers (digests) on every rank after a step."""
    return all(path(r)["digests"] == path(ranks[0])["digests"] for r in ranks[1:])


def compare(spec: Dict, ref: Dict, ranks: List[Dict], meta: Dict) -> List[Dict]:
    """The checks: the ranks' step against the reference's plain step (and
    the reference's group of one against it), parameters equal across
    ranks, launches, times."""
    plain, world1 = ref["plain"], ref["world1"]
    rows = []

    def row(name, ok, **fields):
        rows.append({"check": name, **meta, "ok": bool(ok), **fields})

    def common(path):
        recs = [path(r) for r in ranks]
        return {"launches": [rec["launches"] for rec in recs],
                "plain_launches": path(plain)["launches"],
                "world1_launches": path(world1)["launches"],
                "ms": [rec["ms"] for rec in recs], "warm_ms": [rec.get("warm_ms") for rec in recs],
                "plain_ms": path(plain)["ms"], "plain_warm_ms": path(plain).get("warm_ms"),
                "allreduce_ms": [rec.get("allreduce_ms") for rec in recs],
                "allreduce_bytes": recs[0].get("allreduce_bytes"),
                "peak_gib": [r["peak_gib"] for r in ranks]}

    if "cwt" in spec["checks"]:
        for tile in TILES:
            path = lambda d, t=tile: d["cwt"][f"tile{t}"]  # noqa: E731
            want = path(plain)["grads"]
            err, name = _max_rel(path(ranks[0])["grads"], want)
            err1, _ = _max_rel(path(world1)["grads"], want)
            # layer_norm.bias shifts both class rows alike: the K=2 loss has
            # no gradient in it
            live = all(float(g.abs().max()) > 0 for k, g in want.items()
                       if k != "layer_norm.bias")
            equal = _ranks_equal(ranks, path)
            row("cwt_step", err <= 1e-3 and err1 <= 1e-3 and live and equal, tile=tile,
                max_rel_err=err, worst=name, world1_max_rel_err=err1, limit=1e-3,
                grads_live=live, params_equal_across_ranks=equal, **common(path))
    for shot in (spec["mmn"].get("shots", [1]) if "mmn" in spec["checks"] else []):
        heads = plain["mmn"][shot]
        for head in heads:
            path = lambda d, h=head, s=shot: d["mmn"][s][h]  # noqa: E731
            # held against one process running the ranks' slices (the
            # prologue's batches: the backbone's results depend on the batch
            # it runs); the distance from one process on the whole batch is
            # reported beside it
            joint, want = path(plain)["grads"], path(plain)["split_grads"]
            effect = _max_rel(joint, want)[0]
            live = all(float(g.abs().max()) > 0 for g in want.values())
            equal = _ranks_equal(ranks, path)
            err1, _ = _max_rel(path(world1)["grads"], joint)
            if head == "fp32_head":
                err, name = _max_rel(path(ranks[0])["grads"], want)
                ok, fields = err <= 1e-3 and err1 <= 1e-3, {"limit": 1e-3}
            else:
                # phase 6's bf16 hold: per tensor in L2, within max(5e-2, twice
                # the bf16 head's own distance from the fp32 head's gradient)
                g32 = heads["fp32_head"]["split_grads"]
                limits = {k: max(5e-2, 2 * _rel_l2(w, g32[k])) for k, w in want.items()}
                errs = {k: _rel_l2(path(ranks[0])["grads"][k], w) for k, w in want.items()}
                name = max(errs, key=lambda k: errs[k] / limits[k])
                err = errs[name]
                ok = all(errs[k] <= limits[k] for k in errs) and err1 <= 1e-3
                fields = {"limit": limits[name], "l2": True}
            row("mmn_step", ok and live and equal, shot=shot, head=head, max_rel_err=err,
                worst=name, whole_batch_max_rel_err=effect,
                world1_max_rel_err=err1, grads_live=live, params_equal_across_ranks=equal,
                **fields, **common(path))
    if "pretrain" in spec["checks"]:
        # the JAX package's bar (tests/test_parallel.py): the ranks' step
        # against the one-process step of the same code (the group of one,
        # global-batch BN), at most 3x as far as two computations of that
        # step in one process are from each other (1e-6 at least): its rerun
        # on the batch permuted, and the single-process path (torch's batch
        # norm). The port's global BN sums in float64, so the permuted rerun
        # alone barely moves; torch's batch norm shows the step's fp32 noise
        path = lambda d: d["pretrain"]["step"]  # noqa: E731
        want = path(world1)
        dev = _max_abs(path(ranks[0])["params"], want["params"])
        plain_dev = _max_abs(path(plain)["params"], want["params"])
        permuted = world1["pretrain"]["envelope"]
        envelope = max(permuted, plain_dev, 1e-6)
        bn, bn_name = _max_rel(path(ranks[0])["buffers"], want["buffers"])
        loss = float(path(ranks[0])["metrics"]["loss"])
        loss_err = abs(loss - float(want["metrics"]["loss"])) / abs(float(want["metrics"]["loss"]))
        equal = _ranks_equal(ranks, path)
        row("pretrain_step", dev <= 3 * envelope and bn <= 1e-5 and loss_err <= 1e-5 and equal,
            max_abs_dev=dev, envelope=envelope, limit=3 * envelope,
            permuted_max_abs_dev=permuted, plain_max_abs_dev=plain_dev, bn_max_rel_err=bn, bn_worst=bn_name, bn_limit=1e-5,
            loss_rel_err=loss_err, params_equal_across_ranks=equal, **common(path))
    if "eval" in spec["checks"]:
        got, want = ranks[0]["eval"]["metrics"], plain["eval"]["metrics"]
        px = plain["eval"]["pixels"]
        area = max(float(np.abs(got[k] - want[k]).max()) for k in ("inter", "union"))
        loss_err = float(np.max(np.abs(got["loss"] - want["loss"]) / np.abs(want["loss"])))
        same = all(np.array_equal(r["eval"]["metrics"]["cls"], want["cls"]) for r in ranks)
        row("eval_gathered", area <= 0.005 * px and loss_err <= 1e-3 and same,
            max_area_err=area, area_limit=0.005 * px, loss_rel_err=loss_err, loss_limit=1e-3,
            launches=[r["eval"]["launches"] for r in ranks],
            plain_launches=plain["eval"]["launches"], ms=[r["eval"]["ms"] for r in ranks],
            plain_ms=plain["eval"]["ms"])
    if "validate" in spec["checks"]:
        got, want = ranks[0]["validate"], plain["validate"]
        errs = {k: abs(got[k] - want[k]) for k in ("miou", "episodic_miou")}
        lerrs = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
                 for k in ("loss", "episodic_loss")}
        same = all(r["validate"][k] == got[k] for r in ranks
                   for k in ("miou", "loss", "episodic_miou", "episodic_loss"))
        row("validate", max(errs.values()) <= 2e-3 and max(lerrs.values()) <= 1e-3 and same,
            miou=got["miou"], plain_miou=want["miou"], episodic_miou=got["episodic_miou"],
            plain_episodic_miou=want["episodic_miou"], max_miou_err=max(errs.values()),
            miou_limit=2e-3, max_loss_rel_err=max(lerrs.values()), loss_limit=1e-3,
            ranks_agree=same, launches=[r["validate"]["launches"] for r in ranks],
            ms=[r["validate"]["ms"] for r in ranks], plain_ms=want["ms"])
    if "collectives" in spec["checks"]:
        got, want = ranks[0]["collectives"], plain["collectives"]
        n = len(ranks)
        rows_ok = np.array_equal(got["gathered"]["rows"],
                                 np.concatenate([np.arange(6).reshape(2, 3) + 100 * r
                                                 for r in range(n)]))
        scalars_ok = np.array_equal(got["gathered"]["scalar"], np.arange(n, dtype=np.float32))
        flags_ok = np.array_equal(got["gathered"]["flag"],
                                  np.array([r % 2 == 0 for r in range(n)]))
        same = all(all(np.array_equal(r["collectives"]["gathered"][k], got["gathered"][k])
                       for k in got["gathered"]) for r in ranks)
        errs = {k: float((torch.as_tensor(got["bn"][k]).double()
                          - torch.as_tensor(want["bn"][k]).double()).abs().max()
                         / torch.as_tensor(want["bn"][k]).double().abs().max())
                for k in want["bn"]}
        row("collectives", rows_ok and scalars_ok and flags_ok and same
            and max(errs.values()) <= 1e-12, to_host_rank_order=rows_ok and scalars_ok
            and flags_ok, ranks_agree=same, syncbn_max_rel_err=errs, syncbn_limit=1e-12)
    return rows


def launch(world: int, backend: str, device: str, spec: Dict, work: str,
           threads: int = 1, timeout: float = 900.0,
           spec_path: Optional[str] = None) -> List[Dict]:
    """Run the reference process and the N rank processes (one after the
    other on the card, together on the CPU), and compare; returns the rows
    (one per check). ``work`` receives the spec, the stores, each process's
    log and results; ``spec_path``, where given, is ``spec`` saved already."""
    cards = torch.cuda.device_count() if device == "cuda" else 0
    if device == "cuda" and cards < 1:
        raise RuntimeError("dryrun --device cuda: no CUDA device")
    shared = device == "cuda" and cards < world
    if shared and backend == "nccl":
        raise ValueError(f"NCCL refuses two ranks on one card: {world} ranks, {cards} card(s); "
                         "pass --backend gloo to share cuda:0")
    rank_devices = (["cuda:0"] * world if shared else
                    [f"cuda:{r}" for r in range(world)] if device == "cuda" else ["cpu"] * world)
    os.makedirs(work, exist_ok=True)
    if spec_path is None:
        spec_path = os.path.join(work, "spec.pt")
        torch.save(spec, spec_path)
    backend1 = "nccl" if device == "cuda" else "gloo"
    reference = _start(1, backend1, [rank_devices[0]], "reference", spec_path, work, world,
                       threads)
    if device == "cuda":
        # one after the other: the times of each are the card's alone
        ref = _wait(reference, timeout)[0]
        ranks = _wait(_start(world, backend, rank_devices, "rank", spec_path, work, world,
                             threads), timeout)
    else:
        procs = reference + _start(world, backend, rank_devices, "rank", spec_path, work,
                                   world, threads)
        ref, *ranks = _wait(procs, timeout)
    ranks = [out["rank"] for out in ranks]
    meta = {"world": world, "backend": backend, "device": device, "cards": cards,
            "shared_card": shared, "world1_backend": backend1}
    rows = [{"check": "launch", **meta, "ok": True,
             "rank_devices": rank_devices,
             "kind": torch.cuda.get_device_name(0) if cards else "cpu"}]
    rows += compare(spec, ref, ranks, meta)
    if "trainers" in spec["checks"]:
        rows.append({"check": "trainers", **meta, "ok": True,
                     "results": [r.get("trainers") for r in ranks]})
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    p.add_argument("--size", type=int, default=473)
    p.add_argument("--adapt-iter", type=int, default=200)
    p.add_argument("--checks", default=",".join(CHECKS[:6]))
    p.add_argument("--spec", default=None, help="torch.save'd spec dict (default_spec's keys)")
    p.add_argument("--out", default=None, help="work directory (default: a temporary one)")
    p.add_argument("--threads", type=int, default=1, help="torch threads a process")
    # a worker process (started by the launcher)
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--role", default="rank", help=argparse.SUPPRESS)
    p.add_argument("--store", help=argparse.SUPPRESS)
    p.add_argument("--result", help=argparse.SUPPRESS)
    p.add_argument("--rank-device", help=argparse.SUPPRESS)
    p.add_argument("--n-ranks", type=int, default=1, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        worker(args)
        return 0
    if args.spec:
        spec = torch.load(args.spec, map_location="cpu", weights_only=False)
    else:
        spec = default_spec(args.size, args.adapt_iter, args.checks.split(","))
    work = args.out or tempfile.mkdtemp(prefix="fss_dryrun_")
    spec_path = args.spec
    if "trainers" in spec["checks"] and spec["trainers"].get("dir") is None:
        spec["trainers"]["dir"] = os.path.abspath(os.path.join(work, "trainers"))
        os.makedirs(spec["trainers"]["dir"], exist_ok=True)
        spec_path = None
    rows = launch(args.world, args.backend, args.device, spec, work, args.threads,
                  spec_path=spec_path)
    for r in rows:
        print(json.dumps(r, default=float))
    return 0 if all(r["ok"] for r in rows) else 3


if __name__ == "__main__":
    sys.exit(main())
