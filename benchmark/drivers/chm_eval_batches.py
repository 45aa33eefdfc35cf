"""The evaluation protocol on the CHM head: batches of ``batch`` one-shot
episodes back to back through ``HeadEngine(cfg, "chm").eval_metrics_batch``,
each batch's per-episode metrics pulled to the host as ``eval/validate.py``
pulls them.

Set-up checks first that the program counts its conv4d route, then makes
the seeded backbone (BN calibrated) and head (``reference/chm.py``'s
schema, group weights made live, the two biases calibrated by the
reference on a seeded episode), ``pool_batches`` distinct screened batches
and their classifier inits on the device, builds the engine, and warms the
one shape up; a run whose warm-up batch counts other than two conv4d
calls an episode on the configuration's route, or any on another, reads
not correct.

The comparison: ``check_batches`` batches completed in the window, drawn
from the seed, through the reference (features and stage-4 taps, the
200-step inner loop by autograd, the CHM head, the three classifiers'
tails) on the same inputs and weights; each episode's cross-entropy as a
relative gap, and its intersection and union areas of ``pred``, ``pred1``
and ``pred0`` as a share of its valid pixels.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

import torch

from benchmark import chm_work
from benchmark import work as W
from benchmark.harness import episodes, program
from benchmark.harness.weights import make_state
from benchmark.reference import chm as ref_chm
from benchmark.reference import cwt as ref_cwt
from benchmark.reference import pspnet as ref_pspnet
from benchmark.reference.precision import lower_precision

ROUTES = ("q", "qp", "gemm", "loop")


def _route_counts() -> Dict[str, int]:
    from few_shot_seg_cwt_tpu_torch import ops

    return ops.launch_counts(*(f"conv4d_{r}" for r in ROUTES))


def _route_fault(want: Dict[str, int], what: str) -> Optional[str]:
    got = _route_counts()
    return None if got == want else f"{what}: conv4d calls by route {got}, expected {want}"


def _expected(route: str, calls: int) -> Dict[str, int]:
    return {f"conv4d_{r}": (calls if r == route else 0) for r in ROUTES}


def _stage(cfg) -> int:
    return int(str(cfg.rmid)[-1])


def setup(ctx) -> Dict:
    from few_shot_seg_cwt_tpu_torch.episodic.heads import HeadEngine, build_chm
    from few_shot_seg_cwt_tpu_torch.models.conv4d import conv4d, conv4d_im2col_mode
    from few_shot_seg_cwt_tpu_torch.utils import tracing

    cfg, dev, gen, tr = ctx.cfg, ctx.device, ctx.gen, ctx.cell.traffic
    route = conv4d_im2col_mode()
    if route != ctx.cell.config["env"]["FSS_CONV4D_IM2COL"]:
        raise RuntimeError(f"conv4d route {route!r}, the configuration states "
                           f"{ctx.cell.config['env']['FSS_CONV4D_IM2COL']!r}")
    # a program whose conv4d counts nothing cannot show its route: stop now
    tracing.reset()
    conv4d(torch.zeros((1, 3, 3, 3, 3, 1), device=dev), torch.zeros((3, 3, 3, 3, 1, 1),
                                                                    device=dev))
    fault = _route_fault(_expected(route, 1), "one conv4d call")
    if fault:
        raise RuntimeError(fault)

    e, n_pool = int(tr["batch"]), int(tr["pool_batches"])
    stage = _stage(cfg)
    sd = program.backbone_state(cfg, gen, dev)
    head = make_state(ref_chm.schema(in_dim=cfg.backbone_dim, feat_dim=cfg.backbone_dim),
                      gen, dev)
    ref_chm.live_groups(head)
    calib = episodes.episodes(gen, 1, cfg.image_size, dev)
    _, taps = ref_pspnet.features(sd, torch.cat([calib["q_img"], calib["s_img"][:, 0]]),
                                  cfg.layers, taps=(stage,))
    halved = ref_chm.halve(taps[stage])
    spread = ref_chm.calibrate(head, halved[:1], halved[1:])
    print(f"chm calibration: biases {float(head['chm6d.bias']):.4g} / "
          f"{float(head['chm4d.bias']):.4g}, pre-activation quartiles {spread}",
          file=sys.stderr)
    pool = episodes.episodes(gen, e * n_pool, cfg.image_size, dev)
    w0 = episodes.classifier_inits(gen, e * n_pool, cfg.num_classes_tr, cfg.bottleneck_dim, dev)
    pool, w0 = episodes.screened(gen, pool, w0, sd, cfg, dev)
    chm = build_chm(cfg).to(dev)
    chm.load_state_dict(head, strict=True)
    engine = HeadEngine(cfg, "chm", backbone=program.pspnet(cfg, _program_names(sd, cfg), dev),
                        head=chm, device=dev)
    batches = [{k: v[b * e:(b + 1) * e] for k, v in pool.items()} for b in range(n_pool)]
    state = {"cfg": cfg, "engine": engine, "batches": batches,
             "w0": [w0[b * e:(b + 1) * e] for b in range(n_pool)], "sd": sd, "head": head,
             "e": e, "stage": stage}
    tracing.reset()
    step(state, 0)             # warms the one shape up
    # a batch off the route, or with calls missing, is not the cell's program
    state["route_fault"] = _route_fault(_expected(route, 2 * e), f"a batch of {e}")
    return state


def _program_names(sd: Dict[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """The backbone's weights under the program's names: ``dist cosN``
    wraps the backbone's own classifier (which the episodes never read) in
    ``classifier.cls``."""
    if cfg.dist not in ("cos", "cosN"):
        return sd
    return {k.replace("classifier.", "classifier.cls.", 1) if k.startswith("classifier.")
            else k: v for k, v in sd.items()}


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
    from few_shot_seg_cwt_tpu_torch.episodic import heads as heads_mod

    return [(state["engine"].backbone, "extract_features", "backbone"),
            (heads_mod, "adapt_classifier_batch", "inner_loop")]


def work(state) -> Dict[str, float]:
    """A batch's FLOPs and its Hough convolutions' bound."""
    cfg, e = state["cfg"], state["e"]
    half = W.feature_side(cfg.image_size) // 2
    return {"flops_per_item": chm_work.eval_flops(state["sd"], state["head"], e,
                                                  cfg.image_size, cfg.layers, state["stage"],
                                                  cfg.num_classes_tr, cfg.bottleneck_dim,
                                                  cfg.adapt_iter, cfg.att_wt, cfg.temp),
            "chm_bound_ms": chm_work.chm_bound_ms(e, half)}


def free(state) -> None:
    state.pop("engine", None)


AREAS = ("inter", "union", "inter1", "union1", "inter0", "union0")


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
            loss_gap = max(loss_gap, float(((got["loss"] - ref["loss"]).abs()
                                            / ref["loss"].abs()).max()))
            for k in AREAS:
                gap = (got[k] - ref[k]).abs().amax(1) / valid
                area_gap = max(area_gap, float(gap.max()))
    if state["route_fault"]:
        print(f"{state['route_fault']}; loss_gap {loss_gap!r}, area_gap {area_gap!r}",
              file=sys.stderr)
        return {"loss_gap": float("inf"), "area_gap": float("inf")}
    return {"loss_gap": loss_gap, "area_gap": area_gap}


def reference(state, batch, w0) -> Dict[str, torch.Tensor]:
    """The reference's per-episode outputs for one batch, on the host."""
    cfg, e, stage = state["cfg"], state["e"], state["stage"]
    feat, taps = ref_pspnet.features(state["sd"], torch.cat([batch["s_img"][:, 0],
                                                             batch["q_img"]]),
                                     cfg.layers, taps=(stage,))
    w = ref_cwt.adapt(feat[:e], batch["s_label"][:, 0], w0, cfg.adapt_iter, cfg.cls_lr)
    out = ref_chm.eval_metrics(state["head"], w, feat[e:], feat[:e], taps[stage][e:],
                               taps[stage][:e], batch["q_label"], cfg.att_wt, cfg.temp)
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
