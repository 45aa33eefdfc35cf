"""Meta-training of the MMN head: ``HeadEngine(cfg, "mmn").make_train_step``
with the optimizer and scheduler of ``train/optim.py:build_optimizer``, as
``train/train_head.py`` builds them, each step on ``batch`` episodes and
their classifier inits from a staged seeded pool, back to back; the loss
comes to the host every ``log_every`` steps, as the trainer logs it.

Set-up builds the one step object and drives it through ``checked_steps``
steps on distinct pool entries, recording each step's loss, the head's
parameters before the first step and after the last, and the optimizer's
momentum after the last; the window then goes on with the same object.
Inside the window, at a step drawn from the seed among its first
``window_check_within``, the head's parameters and momentum are copied on
the device (a few KB); that step's loss and those of the next
``checked_steps`` - 1 are kept, and the parameters after the last of them.

The comparison: the reference follows the set-up's steps from the same
weights and inputs (features, inner loop by autograd, the head's loss and
its gradient by autograd, SGD with Nesterov momentum at the scheduler's
rates), and the window's checked steps from the program's copy of its
state at the first of them (the one stage it takes from the program; the
set-up's steps check that stage from the start). Readings: the largest
relative gap of a step's loss, over both runs of steps; leaf by leaf, the
gap between the program's and the reference's norms of the parameters'
change over each run of steps, against the larger of the reference's norm
of that leaf and of the median leaf, the worst leaf's (leaves whose
reference first gradient is under a thousandth of the median leaf's move
by round-off alone and are left out); and the same gap of the optimizer's
momentum after the set-up's steps, the gradients of all of them (the
first gradient alone is rounding where the first batch's dice loss is
saturated: PERF.md, §2).

With ``world`` above 1 (``harness/ddp.py``) each of ``world`` ranks, one a
card, trains on its slice of the ``batch`` episodes of every step, the
gradients averaged by the program's all-reduce (``parallel/mesh.py``); a
checked step's loss is the mean over the ranks, and the reference follows
the steps in one process on the whole batch.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List

import torch
import torch.distributed as dist

from benchmark import work as W
from benchmark.harness import ddp, episodes, program, trace
from benchmark.harness.weights import clone_state, make_state
from benchmark.reference import cwt as ref_cwt
from benchmark.reference import mmn as ref_mmn
from benchmark.reference import pspnet as ref_pspnet
from benchmark.reference.precision import lower_precision


def _bids(cfg):
    return tuple(int(ch) for ch in str(cfg.rmid)[1:])


def setup(ctx) -> Dict:
    from few_shot_seg_cwt_tpu_torch.episodic.heads import HeadEngine
    from few_shot_seg_cwt_tpu_torch.models.mmn import build_mmn
    from few_shot_seg_cwt_tpu_torch.parallel.mesh import broadcast_module
    from few_shot_seg_cwt_tpu_torch.train.optim import build_optimizer

    cfg, dev, gen, tr = ctx.cfg, ctx.device, ctx.gen, ctx.cell.traffic
    world = int(tr.get("world", 1))
    e_all, n_pool, checked = int(tr["batch"]), int(tr["pool_steps"]), int(tr["checked_steps"])
    snap_at = random.Random(ctx.seed).randrange(int(tr["window_check_within"]))
    e = e_all // world
    if e * world != e_all or e != int(tr.get("batch_per_rank", e)):
        raise ValueError(f"a batch of {e_all} does not split into {world} ranks of "
                         f"{tr.get('batch_per_rank', e)}")
    group = (ddp.start(ctx.cell, ctx.seed, world, dev, ctx.shrink)
             if world > 1 and not dist.is_initialized() else None)
    rank = dist.get_rank() if world > 1 else 0
    cfg.episode_batch = e_all
    bids = _bids(cfg)
    sd = program.backbone_state(cfg, gen, dev)
    head0 = make_state(ref_mmn.consensus_schema(len(bids)), gen, dev)
    calib = episodes.episodes(gen, 1, cfg.image_size, dev)
    _, taps = ref_pspnet.features(sd, torch.cat([calib["s_img"][:, 0], calib["q_img"]]),
                                  cfg.layers, taps=bids)
    h = W.feature_side(cfg.image_size)
    ref_mmn.calibrate_consensus(head0, ref_mmn.volume({b: t[1:] for b, t in taps.items()},
                                                      {b: t[:1] for b, t in taps.items()}, bids),
                                (h, h, h, h))
    pool = episodes.episodes(gen, e_all * n_pool, cfg.image_size, dev)
    w0 = episodes.classifier_inits(gen, e_all * n_pool, cfg.num_classes_tr, cfg.bottleneck_dim,
                                   dev)
    pool, w0 = episodes.screened(gen, pool, w0, sd, cfg, dev)
    if world > 1:                          # every rank trains on rank 0's screened pool
        for t in list(pool.values()) + [w0]:
            dist.broadcast(t, 0)
    head = build_mmn(cfg).to(dev)
    head.load_state_dict(head0, strict=True)
    engine = HeadEngine(cfg, "mmn", backbone=program.pspnet(cfg, sd, dev), head=head, device=dev)
    broadcast_module(engine.backbone)      # every rank holds rank 0's weights
    broadcast_module(engine.head)
    base_lr = cfg.trans_lr * cfg.scale_lr
    iters = max(1, cfg.iter_per_epoch // e_all)
    optimizer, scheduler = build_optimizer(engine.head.parameters(), cfg, base_lr=base_lr,
                                           iters_per_epoch=iters)
    lo, hi = rank * e, (rank + 1) * e
    whole = [{k: v[b * e_all:(b + 1) * e_all] for k, v in pool.items()} for b in range(n_pool)]
    w0_whole = [w0[b * e_all:(b + 1) * e_all] for b in range(n_pool)]
    state = {"cfg": cfg, "engine": engine, "step_fn": engine.make_train_step(optimizer, scheduler),
             "whole": whole, "w0_whole": w0_whole,
             "batches": [{k: v[lo:hi] for k, v in b.items()} for b in whole],
             "w0": [w[lo:hi] for w in w0_whole], "sd": sd, "head0": head0, "e": e_all,
             "world": world, "group": group, "tracing": False, "bids": bids,
             "base_lr": base_lr, "total_iters": iters * cfg.epochs, "checked": checked,
             "log_every": int(tr["log_every"]), "optimizer": optimizer,
             "params": dict(engine.head.named_parameters()), "snap_at": snap_at,
             "weight_decay": cfg.weight_decay}
    state["p0"] = _params(state)
    losses = []
    for i in range(checked):
        loss = state["step_fn"](state["batches"][i], w0=state["w0"][i])["loss_mean"].detach()
        if world > 1:                      # the mean over the ranks' slices
            loss = loss.clone()
            dist.all_reduce(loss)
            loss = loss / world
        losses.append(float(loss))
    state["p_end"], state["buf_end"] = _params(state), _momentum(state)
    state["losses"] = losses
    return state


def _params(state) -> Dict[str, torch.Tensor]:
    return {k: p.detach().clone() for k, p in state["params"].items()}


def _momentum(state) -> Dict[str, torch.Tensor]:
    """The optimizer's momentum of each parameter (none before its first step)."""
    out = {}
    for k, p in state["params"].items():
        buf = state["optimizer"].state.get(p, {}).get("momentum_buffer")
        if buf is not None:
            out[k] = buf.detach().clone()
    return out


def window_checked(state) -> range:
    """The window's steps the reference follows."""
    return range(state["snap_at"], state["snap_at"] + state["checked"])


def min_items(state) -> int:
    """The window runs at least up to its last checked step (on the card it
    holds several times as many)."""
    return state["snap_at"] + state["checked"]


def step(state: Dict, i: int) -> Dict:
    if state["group"] is not None and not state["tracing"]:
        state["group"].send(ddp.GO)
    b = (state["checked"] + i) % len(state["batches"])
    if i == state["snap_at"]:
        state["w_p0"], state["w_bufs"] = _params(state), _momentum(state)
    metrics = state["step_fn"](state["batches"][b], w0=state["w0"][b])
    if i == state["snap_at"] + state["checked"] - 1:
        state["w_p_end"] = _params(state)
    loss = metrics["loss_mean"]
    if i % state["log_every"] == 0:
        loss = float(loss)
    return {"batch": b, "loss": loss}


def finish(state, records) -> None:
    program.sync(state["engine"].device)
    if state["group"] is not None:
        state["group"].send(ddp.STOP)
        reports = state["group"].gather(report(state, records))
        state["peak"] = max(g["peak"] for g in reports)
    else:
        reports = [report(state, records)]
    # the measured window's records; a traced window's come after it
    if "w_losses" not in state and len(reports[0]["losses"]) == state["checked"]:
        state["w_losses"] = [sum(g["losses"][k] for g in reports) / len(reports)
                             for k in range(state["checked"])]


def report(state, records) -> Dict:
    """This rank's peak memory and its losses of the window's checked steps
    (what the other ranks send rank 0 when the window ends)."""
    steps = [i for i in window_checked(state) if i < len(records)]
    return {"peak": _peak(state), "losses": [float(records[i]["loss"]) for i in steps]}


def _peak(state) -> int:
    dev = state["engine"].device
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def memory_peak(state) -> int:
    """The fullest card's peak, every rank's taken at the window's end."""
    return state["peak"] if state["group"] is not None else _peak(state)


def traced_window(state, n: int, device, step_fn) -> "trace.Trace":
    """Every rank traces the same ``n`` steps; the busy time is their mean."""
    group = state["group"]
    if group is None:
        return trace.traced(step_fn, n, device)
    group.send(ddp.TRACE, n)
    state["tracing"] = True
    try:
        tr = trace.traced(step_fn, n, device)
    finally:
        state["tracing"] = False
    tr.rank_busy_s = [g["busy_s"] for g in group.gather({"busy_s": tr.own_busy_s})]
    return tr


def end_to_end(state, records: List[Dict], window_s: float) -> Dict[str, float]:
    """Samples (episodes) of every rank."""
    return {"train_samples_per_s": len(records) * state["e"] / window_s}


def host(records: List[Dict]) -> Dict[str, List[float]]:
    return {}


def spans(state):
    from few_shot_seg_cwt_tpu_torch.episodic import heads as heads_mod

    return [(state["engine"].backbone, "extract_features", "backbone"),
            (heads_mod, "adapt_classifier_batch", "inner_loop"),
            (heads_mod, "all_reduce_grads", "allreduce")]


def work(state) -> Dict[str, float]:
    """A step's FLOPs over every rank, and one rank's consensus bound."""
    cfg, e, world = state["cfg"], state["e"], state["world"]
    h = W.feature_side(cfg.image_size)
    calls = W.consensus_calls((len(state["bids"]), 10, 10, 1), (h, h, h, h),
                              episodes=e // world)
    return {"flops_per_item": W.mmn_step_flops(state["sd"], state["head0"], e, cfg.image_size,
                                               cfg.layers, state["bids"], cfg.temp,
                                               cfg.num_classes_tr, cfg.bottleneck_dim,
                                               cfg.adapt_iter),
            "consensus_bound_ms": W.consensus_bound_ms(calls), "chips": world}


def free(state) -> None:
    for k in ("engine", "step_fn", "optimizer", "params"):
        state.pop(k, None)
    if state["group"] is not None:
        state.pop("group").close()
        state["group"] = None


def cosine_lr(base: float, total: int, step: int, eta_min: float = 1e-6) -> float:
    t = min(step, total) / total
    return (base - eta_min) * 0.5 * (1.0 + math.cos(math.pi * t)) + eta_min


def reference_steps(state, params: Dict[str, torch.Tensor], bufs: Dict[str, torch.Tensor],
                    steps: range) -> Dict:
    """The reference's losses, first gradient, final parameters and momentum over the
    optimizer's steps ``steps`` (0 is the first of set-up; window step i is
    ``checked`` + i), from ``params`` and momentum ``bufs``."""
    cfg, e, bids = state["cfg"], state["e"], state["bids"]
    params, bufs = clone_state(params), clone_state(bufs)
    losses, grad1 = [], None
    for k in steps:
        b = k % len(state["whole"])
        batch, w0 = state["whole"][b], state["w0_whole"][b]
        feat, taps = ref_pspnet.features(state["sd"], torch.cat([batch["s_img"][:, 0],
                                                                 batch["q_img"]]),
                                         cfg.layers, taps=bids)
        w = ref_cwt.adapt(feat[:e], batch["s_label"][:, 0], w0, cfg.adapt_iter, cfg.cls_lr)
        live = {n: p.detach().requires_grad_(True) for n, p in params.items()}
        grads = {n: torch.zeros_like(p) for n, p in params.items()}
        total = 0.0
        for i in range(e):
            with torch.enable_grad():
                loss = ref_mmn.episode_loss(
                    live, {b: t[e + i:e + i + 1] for b, t in taps.items()},
                    {b: t[i:i + 1] for b, t in taps.items()}, feat[i:i + 1], w[i],
                    batch["q_label"][i], bids, cfg.temp) / e
                got = torch.autograd.grad(loss, list(live.values()))
            for n, g in zip(live, got):
                grads[n] += g
            total += float(loss.detach())
        losses.append(total)
        if grad1 is None:
            grad1 = {n: g.clone() for n, g in grads.items()}
        lr = cosine_lr(state["base_lr"], state["total_iters"], k)
        ref_mmn.sgd_step(params, grads, bufs, lr, cfg.momentum, cfg.weight_decay)
    return {"losses": losses, "grad1": grad1, "p_end": params, "bufs": bufs}


def references(state) -> Dict[str, Dict]:
    """The reference over the set-up's steps from the start, and over the
    window's checked steps from the program's state before the first."""
    c = state["checked"]
    out = {"setup": reference_steps(state, state["head0"], {}, range(c))}
    if "w_losses" in state:
        s0 = c + state["snap_at"]
        out["window"] = reference_steps(state, state["w_p0"], state["w_bufs"], range(s0, s0 + c))
    return out


def leaf_gaps(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], leaves) -> float:
    """The worst leaf's |‖got‖ - ‖ref‖| over the larger of ‖ref‖ and the
    median leaf's ‖ref‖, the median taken over the leaves whose ‖ref‖ is
    not exactly 0. Where ‖ref‖ is 0 on every leaf, any ‖got‖ but 0 reads
    as infinite."""
    norms = {n: float(ref[n].norm()) for n in ref}
    live = sorted(v for v in norms.values() if v > 0)
    median = live[len(live) // 2] if live else 0.0
    gaps = []
    for n in leaves:
        gap, scale = abs(float(got[n].norm()) - norms[n]), max(norms[n], median)
        gaps.append(gap / scale if scale > 0 else (0.0 if gap == 0 else float("inf")))
    return max(gaps)


def _moving(grad1: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the median leaf's."""
    gnorm = {n: float(g.norm()) for n, g in grad1.items()}
    median = sorted(gnorm.values())[len(gnorm) // 2]
    return [n for n, v in gnorm.items() if v >= 1e-3 * median]


def readings(state, records: List[Dict], ctx) -> Dict[str, float]:
    ref = references(state)
    if "window" not in ref:                # the window ended before its checked steps
        return {"loss_gap": float("inf"), "change_gap": float("inf"),
                "momentum_gap": float("inf")}
    runs = [(state["losses"], state["p0"], state["p_end"], state["head0"], ref["setup"]),
            (state["w_losses"], state["w_p0"], state["w_p_end"], state["w_p0"], ref["window"])]
    loss_gap, change_gap = 0.0, 0.0
    for losses, p0, p_end, ref_p0, r in runs:
        loss_gap = max([loss_gap] + [abs(a - b) / abs(b) for a, b in zip(losses, r["losses"])])
        change = {n: p_end[n] - p0[n] for n in p0}
        change_ref = {n: r["p_end"][n] - ref_p0[n] for n in ref_p0}
        change_gap = max(change_gap, leaf_gaps(change, change_ref, _moving(r["grad1"])))
    bufs = ref["setup"]["bufs"]                # a step left undone keeps no momentum
    got = {n: state["buf_end"].get(n, torch.zeros_like(b)) for n, b in bufs.items()}
    return {"loss_gap": loss_gap, "change_gap": change_gap,
            "momentum_gap": leaf_gaps(got, bufs, list(bufs))}


def control(state, records: List[Dict]) -> None:
    """The reference at TF32 in the program's place: the checked steps'
    losses, final parameters and momentum, in set-up and in the window,
    become the lower-precision reference's."""
    with lower_precision():
        ref = references(state)
    state["p0"] = {n: p.clone() for n, p in state["head0"].items()}
    state["losses"], state["buf_end"] = ref["setup"]["losses"], ref["setup"]["bufs"]
    state["p_end"] = ref["setup"]["p_end"]
    if "window" in ref:
        state["w_losses"], state["w_p_end"] = ref["window"]["losses"], ref["window"]["p_end"]
