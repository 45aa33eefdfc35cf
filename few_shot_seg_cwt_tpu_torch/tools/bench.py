"""The port's benchmark: one JSON line of throughput on the card.

    python -m few_shot_seg_cwt_tpu_torch.tools.bench
    BENCH_MODE=pretrain python -m few_shot_seg_cwt_tpu_torch.tools.bench

Counterpart of the repository root's ``bench.py`` (the JAX bench), with its
knobs, read from the environment (``run`` also takes them as keyword
arguments, lower case without the ``BENCH_`` prefix):

* ``BENCH_MODE``: ``eval`` (CWT ``eval_metrics_batch``; ``BENCH_EVAL_PROGRAM``
  ``logits`` times ``eval_batch_from_w0``, ``no_cwt`` the CWT-free program
  of stage-1 validation), ``train`` (the CWT meta-train step;
  ``BENCH_TRAIN_METRICS=0`` the loss-only step), ``head`` (the head's train
  step, ``BENCH_HEAD``), ``head_eval``, ``head_serve``, ``pretrain`` (the stage-1 step on
  ``BENCH_PRETRAIN_BATCH`` images, 16 classes, fp32) or ``backbone`` (the
  feature extractor alone on an eval batch's images);
* ``BENCH_EPISODE_BATCH``: the card's batches by default, the sizes
  ``chip_smoke.py`` runs (CWT 8, MMN eval and serve 4, MMN train 2);
  ``BENCH_PRETRAIN_BATCH`` (16); ``BENCH_BATCHES`` timed batches (24);
* ``BENCH_IMAGE_SIZE`` (473), ``BENCH_DTYPE`` (``float32`` or ``bfloat16``:
  the backbone's ``compute_dtype``; the MMN modes' ``use_amp``),
  ``BENCH_BF16_STAGES``, ``BENCH_SHOT`` (1), ``BENCH_ADAPT_ITER`` (the
  config's 200), ``BENCH_HEAD`` (``mmn``; ``match`` or ``chm``
  with configs/pascal_match.yaml's model settings, ``crm_type chm`` for
  ``chm``; ``detr`` with configs/pascal_trans.yaml's; ``att``, ``asy`` and
  ``fuse`` with MMN's, as the JAX bench runs any other head; ``cca``, the
  incremental engine with MMN's and a 17-way base classifier),
  ``BENCH_OPTS`` (``key value
  ...`` as ``--opts``),
  ``BENCH_QUIET=1`` (no progress lines on stderr).

Inputs (three batches, synthetic, seeded) are staged on the device before
timing. After a warm-up call, one call runs under
``torch.utils.flop_counter.FlopCounterMode`` with the hand-written kernels'
work added (``roofline.kernel_work``), outside the timed window; then
``BENCH_BATCHES`` calls each end in a device synchronise and are timed by
the host clock. The line reports the median rate and the p10/p50/p90 rates,
FLOPs per episode (per image in ``pretrain``) and the model FLOP
utilisation against the H100's dense peak of the backbone's dtype (fp32
with TF32 off 67 TFLOP/s, bf16 989), the peak memory and the card's name
and power limit. The inner-loop launches that ``FSS_INNER_TILE`` selects
are those of the environment, as in the entry points. No TPU figure and no baseline
estimate carry over. On the CPU (``device="cpu"``, for tests) the line
names the CPU and gives no utilisation, peak or memory figure.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from ..config import default_cfg, merge_cfg_from_list
from ..data.synthetic import make_episode_batch
from .roofline import PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, card_line, kernel_work

MODES = ("eval", "train", "head", "head_eval", "head_serve", "pretrain", "backbone")
# the card's default batches: what chip_smoke.py runs at 473 px
DEFAULT_BATCH = {"eval": 8, "train": 8, "backbone": 8, "head": 2, "head_eval": 4,
                 "head_serve": 4}
# the MMN hyperparameters of configs/pascal_mmn.yaml, as the JAX bench sets them
MMN_KNOBS = dict(conv4d="red", temp=20.0, att_wt=0.2, loss_type="wt_dc", rmid="l34",
                 wa=True, proj_drop=0.5, att_drop=0.5, trans_lr=0.0015)
# the match head's: configs/pascal_match.yaml's MODEL and Classifier sections
# and its trans_lr (stage-4 taps, cycle mask on at eval, cosine classifier)
MATCH_KNOBS = dict(crm_type="nc", conv4d="red", ignore=False, temp=20.0, rmid="mid4",
                   att_wt=0.2, sce=False, cyc=True, dist="cosN", cls_type="ooo",
                   trans_lr=0.0001)
# the CHM head: the match settings with crm_type chm (train_match's route)
CHM_KNOBS = dict(MATCH_KNOBS, crm_type="chm")
# DeTr: configs/pascal_trans.yaml's MODEL section and its trans_lr
DETR_KNOBS = dict(rmid="l34", temp=20.0, att_wt=0.2, sf_att=False, cr_att=True,
                  trans_lr=0.0015)
HEAD_KNOBS = {"mmn": MMN_KNOBS, "match": MATCH_KNOBS, "chm": CHM_KNOBS, "detr": DETR_KNOBS}


def _knob(knobs: Dict[str, Any], name: str, default):
    if name in knobs and knobs[name] is not None:
        return knobs[name]
    return os.environ.get("BENCH_" + name.upper(), default)


def _progress(knobs: Dict[str, Any], msg: str) -> None:
    if str(_knob(knobs, "quiet", "0")) != "1":
        print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _config(knobs: Dict[str, Any], size: int, dtype: str, shot: int):
    cfg = default_cfg()
    cfg.image_size, cfg.compute_dtype, cfg.shot = size, dtype, shot
    cfg.bf16_stages = _knob(knobs, "bf16_stages", None) or None
    cfg.adapt_iter = int(_knob(knobs, "adapt_iter", cfg.adapt_iter))
    opts = str(_knob(knobs, "opts", "") or "")
    return merge_cfg_from_list(cfg, opts.split()) if opts else cfg


def _head_engine(cfg, head: str, dtype: str, device):
    """The head's engine with its ``HEAD_KNOBS`` (MMN's for a head without
    its own: att, asy, fuse, cca). ``cca`` is the incremental engine
    (``episodic.cca.CCAEngine``) over a 17-way base classifier, as the JAX
    bench builds it (the synthetic episodes' classes are 1..16)."""
    from ..episodic.heads import HeadEngine

    for k, v in HEAD_KNOBS.get(head, MMN_KNOBS).items():
        cfg[k] = v
    cfg.use_amp = dtype == "bfloat16"
    if head == "cca":
        from ..episodic.cca import CCAEngine

        cfg.num_classes_tr = 17
        return CCAEngine(cfg, device=device)
    return HeadEngine(cfg, head, device=device)


def _program(mode: str, knobs: Dict[str, Any], cfg, e: int, n: int, device, dtype: str
             ) -> Callable[[int], Any]:
    """call(i): the timed call on staged input i (0..n; n is the warm-up and
    FLOP-count input)."""
    from ..episodic.engine import EpisodicEngine

    if mode == "pretrain":
        from ..models.pspnet import build_pspnet
        from ..train.pretrain import build_pretrain_optimizer, make_pretrain_step

        cfg.num_classes_tr = 16          # PASCAL-5i base classes with background
        cfg.compute_dtype, cfg.bf16_stages = "float32", None
        model = build_pspnet(cfg).to(device)
        optimizer, scheduler = build_pretrain_optimizer(model, cfg, iters_per_epoch=1000)
        step = make_pretrain_step(model, optimizer, scheduler, cfg)
        rng = np.random.default_rng(0)
        size = cfg.image_size
        imgs = [torch.tensor(rng.normal(size=(e, size, size, 3)).astype(np.float32),
                             device=device) for _ in range(3)]
        gts = [torch.tensor(rng.integers(0, 16, (e, size, size)).astype(np.int32),
                            device=device) for _ in range(3)]
        gens = [torch.Generator().manual_seed(100 + i) for i in range(n + 1)]
        return lambda i: step(imgs[i % 3], gts[i % 3], gens[i])["loss"]

    staged = []
    for s in range(3):
        host = make_episode_batch(seed=s + 1, e=e, size=cfg.image_size, shot=cfg.shot)
        staged.append({k: torch.as_tensor(host[k]).to(device)
                       for k in ("s_img", "s_label", "q_img", "q_label", "cls")})
    gens = [torch.Generator().manual_seed(100 + i) for i in range(n + 1)]

    if mode in ("head", "head_eval", "head_serve"):
        head = str(_knob(knobs, "head", "mmn"))
        engine = _head_engine(cfg, head, dtype, device)
        if head == "cca":
            # the K-way init is the base classifier with a novel row drawn per episode
            if mode == "head_eval":
                return lambda i: engine.eval_metrics_batch(staged[i % 3], gens[i])["loss"]
            if mode == "head_serve":
                return lambda i: engine.serve_batch(staged[i % 3], gens[i])
        w0s = [engine.init_weights(e, g) for g in gens]
        if mode == "head_eval":
            return lambda i: engine.eval_metrics_batch(staged[i % 3], w0=w0s[i])["loss"]
        if mode == "head_serve":
            return lambda i: engine.serve_batch(staged[i % 3], w0=w0s[i])
        optimizer = torch.optim.SGD(engine.head.parameters(), lr=cfg.trans_lr)
        step = engine.make_train_step(optimizer)
        return lambda i: step(staged[i % 3], gens[i])["loss_mean"]

    engine = EpisodicEngine(cfg, device=device)
    if mode == "backbone":
        imgs = torch.cat([staged[0]["s_img"].flatten(0, 1), staged[0]["q_img"]])
        variants = [imgs + float(i) for i in range(3)]

        def features(i):
            with torch.no_grad():
                return engine.backbone.extract_features(variants[i % 3])

        return features
    if mode == "train":
        optimizer = torch.optim.SGD(engine.cwt.parameters(), lr=cfg.trans_lr)
        with_metrics = str(_knob(knobs, "train_metrics", "1")) != "0"
        step = engine.make_train_step(optimizer, with_metrics=with_metrics)
        return lambda i: step(staged[i % 3], gens[i])["loss"]
    w0s = [engine.init_weights(e, g) for g in gens]
    program = str(_knob(knobs, "eval_program", "metrics"))
    if program == "logits":
        return lambda i: engine.eval_batch_from_w0(staged[i % 3], w0s[i])["pred_q"]
    if program == "no_cwt":
        return lambda i: engine.eval_metrics_batch_no_cwt(staged[i % 3], w0=w0s[i])["loss0"]
    if program != "metrics":
        raise ValueError(f"BENCH_EVAL_PROGRAM {program!r}: metrics, logits or no_cwt")
    return lambda i: engine.eval_metrics_batch(staged[i % 3], w0=w0s[i])["loss"]


def run(mode: Optional[str] = None, device="cuda", **knobs) -> Dict[str, Any]:
    """Benchmark one mode; returns the JSON line's fields. Knobs as the
    environment's ``BENCH_*`` (``episode_batch=4``, ``batches=5``, ...);
    keyword arguments win over the environment."""
    mode = str(mode or _knob(knobs, "mode", "eval"))
    if mode not in MODES:
        raise ValueError(f"BENCH_MODE {mode!r}: one of {MODES}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA device; pass device='cpu' for a CPU run")
    from ..train.common import fp32_parity

    fp32_parity()
    size = int(_knob(knobs, "image_size", 473))
    dtype = str(_knob(knobs, "dtype", "float32"))
    shot = int(_knob(knobs, "shot", 1))
    n = int(_knob(knobs, "batches", 24))
    e = int(_knob(knobs, "pretrain_batch", 16) if mode == "pretrain"
            else _knob(knobs, "episode_batch", DEFAULT_BATCH[mode]))
    cfg = _config(knobs, size, dtype, shot)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    _progress(knobs, f"{mode}: staging inputs and building the program")
    call = _program(mode, knobs, cfg, e, n, device, dtype)
    t0 = time.perf_counter()
    call(n)
    _sync(device)
    warmup_s = time.perf_counter() - t0
    _progress(knobs, f"{mode}: warm-up call {warmup_s:.1f} s; counting FLOPs")
    with FlopCounterMode(display=False) as counter, kernel_work() as kernels:
        call(n)
        _sync(device)
    flops = counter.get_total_flops() + kernels["flops"]

    times: List[float] = []
    for i in range(n):
        t0 = time.perf_counter()
        call(i)
        _sync(device)
        times.append(time.perf_counter() - t0)

    rate = lambda t: e / float(t)  # noqa: E731
    bt = np.asarray(times)
    value = rate(np.median(bt))
    if mode == "pretrain":
        unit, bf16 = "images/s", False
        setting = f"@{size}px, batch {e}, float32"
    else:
        unit, bf16 = "episodes/s", dtype == "bfloat16"
        setting = f"{shot}-shot @{size}px, batch {e}, {dtype}, adapt_iter {cfg.adapt_iter}"
    result: Dict[str, Any] = {
        "metric": f"{mode} {unit} ({setting})",
        "mode": mode,
        "value": value,
        "unit": unit,
        "batch": e,
        "timed_batches": n,
        "median_batch_ms": float(np.median(bt)) * 1e3,
        "rate_p10": rate(np.percentile(bt, 90)),
        "rate_p50": rate(np.percentile(bt, 50)),
        "rate_p90": rate(np.percentile(bt, 10)),
        "warmup_s": warmup_s,
        "flops_per_episode": flops / e,
        "kernel_flops_per_episode": kernels["flops"] / e,
        "kernel_launches": kernels["launches"],
        "platform": device.type,
    }
    if device.type == "cuda":
        peak = PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS
        result.update({
            "mfu": flops / e * value / peak,
            "peak_flops": peak,
            "peak": ("H100 SXM dense bf16, 989 TFLOP/s" if bf16 else
                     "H100 SXM dense fp32 (TF32 off), 67 TFLOP/s"),
            "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2**30,
            "device": torch.cuda.get_device_name(device),
            "card": card_line(),
        })
    else:
        result.update({"mfu": None, "peak_flops": None, "peak": None,
                       "peak_mem_gib": None, "device": "cpu", "card": None})
    return result


def main() -> None:
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
