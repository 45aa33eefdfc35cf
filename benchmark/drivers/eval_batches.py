"""The evaluation protocol: batches of ``batch`` one-shot episodes back to
back through ``EpisodicEngine.eval_metrics_batch``, each batch's
per-episode metrics pulled to the host as ``eval/validate.py`` pulls them.

Inputs: ``pool_batches`` distinct seeded batches and their classifier
inits, staged on the device at set-up; the window cycles through them.
The comparison: ``check_batches`` batches completed in the window, drawn
from the seed, through the reference (features, the 200-step inner loop by
autograd, the transformer, both classifiers' tails) on the same inputs and
weights; each episode's two cross-entropies as a relative gap, and its
intersection and union areas as a share of its valid pixels.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from benchmark import work as W
from benchmark.harness import episodes, program
from benchmark.harness.weights import make_state
from benchmark.reference import cwt as ref_cwt
from benchmark.reference import pspnet as ref_pspnet
from benchmark.reference.precision import lower_precision


def setup(ctx) -> Dict:
    from few_shot_seg_cwt_tpu_torch.episodic.engine import EpisodicEngine
    from few_shot_seg_cwt_tpu_torch.models.cwt import build_cwt

    cfg, dev, gen, tr = ctx.cfg, ctx.device, ctx.gen, ctx.cell.traffic
    e, n_pool = int(tr["batch"]), int(tr["pool_batches"])
    sd = program.backbone_state(cfg, gen, dev)
    sd_cwt = make_state(ref_cwt.transformer_schema(cfg.bottleneck_dim), gen, dev)
    pool = episodes.episodes(gen, e * n_pool, cfg.image_size, dev)
    w0 = episodes.classifier_inits(gen, e * n_pool, cfg.num_classes_tr, cfg.bottleneck_dim, dev)
    pool, w0 = episodes.screened(gen, pool, w0, sd, cfg, dev)
    cwt = build_cwt(cfg).to(dev)
    cwt.load_state_dict(sd_cwt, strict=True)
    engine = EpisodicEngine(cfg, backbone=program.pspnet(cfg, sd, dev), cwt=cwt, device=dev)
    batches = [{k: v[b * e:(b + 1) * e] for k, v in pool.items()} for b in range(n_pool)]
    state = {"cfg": cfg, "engine": engine, "batches": batches,
             "w0": [w0[b * e:(b + 1) * e] for b in range(n_pool)], "sd": sd, "sd_cwt": sd_cwt,
             "e": e, "dev": dev}
    step(state, 0)             # builds the kernels and warms the one shape
    return state


def step(state: Dict, i: int) -> Dict:
    b = i % len(state["batches"])
    out = state["engine"].eval_metrics_batch(state["batches"][b], w0=state["w0"][b])
    host = {k: v.cpu() for k, v in out.items()}
    return {"batch": b, "out": host, "t": time.perf_counter()}


def finish(state, records) -> None:
    """Each step ends with its metrics on the host."""


def end_to_end(state, records: List[Dict], window_s: float) -> Dict[str, float]:
    return {"eval_episodes_per_s": len(records) * state["e"] / window_s}


def host(records: List[Dict]) -> Dict[str, List[float]]:
    ts = [r["t"] for r in records]
    return {"item_ms": [(b - a) * 1e3 for a, b in zip(ts, ts[1:])]}


def spans(state):
    from few_shot_seg_cwt_tpu_torch.episodic import engine as engine_mod

    return [(state["engine"].backbone, "extract_features", "backbone"),
            (engine_mod, "adapt_classifier_batch", "inner_loop")]


def work(state) -> Dict[str, float]:
    """A batch's FLOPs and the inner loop's bound at E = ``batch``."""
    cfg, e = state["cfg"], state["e"]
    h = W.feature_side(cfg.image_size)
    k1 = W.inner_loop_work(e, 1, h, h, cfg.bottleneck_dim, cfg.image_size, cfg.image_size,
                           cfg.adapt_iter)
    return {"flops_per_item": W.cwt_episode_flops(state["sd"], state["sd_cwt"], e,
                                                  cfg.image_size, cfg.layers,
                                                  cfg.num_classes_tr, cfg.bottleneck_dim,
                                                  cfg.adapt_iter),
            "k1_bound_ms": W.bound(*k1)[0]}


def free(state) -> None:
    state.pop("engine", None)


def readings(state, records: List[Dict], ctx) -> Dict[str, float]:
    done = sorted({r["batch"] for r in records})
    picks = ctx.rng.sample(done, min(int(ctx.cell.traffic["check_batches"]), len(done)))
    if not picks:
        return {"loss_gap": float("inf"), "area_gap": float("inf")}
    loss_gap, area_gap = 0.0, 0.0
    for b in picks:
        batch = state["batches"][b]
        ref = reference(state, batch, state["w0"][b])
        valid = (batch["q_label"] != 255).flatten(1).sum(1).float().cpu()
        for got in (r["out"] for r in records if r["batch"] == b):
            for k in ("loss", "loss0"):
                loss_gap = max(loss_gap, float(((got[k] - ref[k]).abs() / ref[k].abs()).max()))
            for k in ("inter", "union", "inter0", "union0"):
                gap = (got[k] - ref[k]).abs().amax(1) / valid
                area_gap = max(area_gap, float(gap.max()))
    return {"loss_gap": loss_gap, "area_gap": area_gap}


def reference(state, batch, w0) -> Dict[str, torch.Tensor]:
    """The reference's per-episode outputs for one batch, on the host."""
    cfg, e = state["cfg"], state["e"]
    feat, _ = ref_pspnet.features(state["sd"], torch.cat([batch["s_img"][:, 0], batch["q_img"]]),
                                  cfg.layers)
    w = ref_cwt.adapt(feat[:e], batch["s_label"][:, 0], w0, cfg.adapt_iter, cfg.cls_lr)
    with torch.no_grad():
        out = ref_cwt.eval_metrics(state["sd_cwt"], w, feat[e:], batch["q_label"])
    return {k: v.cpu() for k, v in out.items()}


def control(state, records: List[Dict]) -> None:
    """The reference at TF32 in the program's place: each record's outputs
    become the lower-precision reference's for its batch."""
    outs = {}
    with lower_precision():
        for b in sorted({r["batch"] for r in records}):
            outs[b] = reference(state, state["batches"][b], state["w0"][b])
    for r in records:
        r["out"] = outs[r["batch"]]
