"""Serving one episode a request to one client that waits for each reply
and paces its requests at a fixed rate: request i is due i / ``rate_per_s``
seconds into the window and goes out when it is due, or when the reply to
the one before it comes, if that is later (then the client catches up, so
the offered rate stays fixed while the server keeps up). Each request is
one episode held in pageable host memory (support image and mask, query
image) with its classifier init, handed to ``EpisodicEngine.serve_batch``
as a batch of one; its latency runs from when it goes out until its mask
is in host memory.

Why a paced client and not an open loop (latency from the due time): in
fresh processes on the card's host a stall of a few hundred ms came in
about one run in four, and queued 10–30 requests behind it, which moved
the 95th percentile between 30 and 51 ms from run to run (H100 80GB
HBM3, 700 W), past any bound the benchmark may set; each request's own latency
held at 29.3 ms median. The client waits by spinning: sleeping until a
request was due added ~2 ms at the median.

The client's pacing sets the window's length, so the per-layer shares of
the device (``mfu.serve``, ``device_idle_pct.serve``) are taken over the
requests' own service intervals, the spans ``request``, and not over the
window: a faster service leaves the window as long and shortens those.

Inputs: a seeded pool of ``pool_requests`` episodes, made on the device
and moved to the host at set-up; the loop cycles through them. The
comparison: ``check_requests`` requests completed in the window, drawn
from the seed, through the reference on the same inputs and weights. A
served pixel is wrong where its side of 0 differs from the reference's
foreground-minus-background logit; the reading is the largest such logit,
as a share of the episode's median absolute logit, and the share of pixels
that differ.
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
    n = int(tr["pool_requests"])
    sd = program.backbone_state(cfg, gen, dev)
    sd_cwt = make_state(ref_cwt.transformer_schema(cfg.bottleneck_dim), gen, dev)
    pool = episodes.episodes(gen, n, cfg.image_size, dev)
    w0 = episodes.classifier_inits(gen, n, cfg.num_classes_tr, cfg.bottleneck_dim, dev)
    pool, w0 = episodes.screened(gen, pool, w0, sd, cfg, dev)
    cwt = build_cwt(cfg).to(dev)
    cwt.load_state_dict(sd_cwt, strict=True)
    engine = EpisodicEngine(cfg, backbone=program.pspnet(cfg, sd, dev), cwt=cwt, device=dev)
    host = {"s_img": pool["s_img"].cpu(), "s_label": pool["s_label"].to(torch.uint8).cpu(),
            "q_img": pool["q_img"].cpu()}
    requests = [({k: v[j:j + 1] for k, v in host.items()}, w0[j:j + 1].cpu()) for j in range(n)]
    state = {"cfg": cfg, "engine": engine, "client": Client(engine), "requests": requests,
             "pool": pool, "w0": w0,
             "sd": sd, "sd_cwt": sd_cwt, "e": 1, "period": 1.0 / float(tr["rate_per_s"]),
             "due": None, "answered": [False] * n,
             "first": torch.zeros((n,) + tuple(pool["q_img"].shape[1:3]), dtype=torch.int32)}
    step(state, 0)             # builds the kernels and warms the one shape
    finish(state, [])
    return state


class Client:
    """A request's service, from its host arrays to its mask in host memory:
    the span ``request`` of a traced window wraps ``answer``."""

    def __init__(self, engine):
        self.engine = engine

    def answer(self, episode, w0) -> torch.Tensor:
        return self.engine.serve_batch(episode, w0=w0).cpu()


def step(state: Dict, i: int) -> Dict:
    j = i % len(state["requests"])
    episode, w0 = state["requests"][j]
    due = state["due"] if state["due"] is not None else time.perf_counter()
    state["due"] = due + state["period"]
    while time.perf_counter() < due:
        pass
    sent = time.perf_counter()
    mask = state["client"].answer(episode, w0)[0]
    ms = (time.perf_counter() - sent) * 1e3
    return {"request": j, "mask": keep(state, j, mask), "ms": ms}


def keep(state: Dict, j: int, mask: torch.Tensor):
    """The served mask for the comparison: the first answer to each pool
    request goes to host memory reserved at set-up; a later answer to the
    same request is kept only where it differs from the first. Keeping
    every answer in fresh host memory stalled the next requests (p95
    33–37 ms against 30.5 without, on an H100 80GB HBM3)."""
    if not state["answered"][j]:
        state["first"][j].copy_(mask)
        state["answered"][j] = True
        return None
    return None if torch.equal(mask, state["first"][j]) else mask.clone()


def served(state: Dict, record: Dict) -> torch.Tensor:
    return state["first"][record["request"]] if record["mask"] is None else record["mask"]


def finish(state, records) -> None:
    """Each request ends with its mask on the host; the schedule starts
    again with the next window."""
    state["due"] = None


def _p(values: List[float], q: float) -> float:
    """The ``q`` quantile, linear between order statistics."""
    return float(torch.quantile(torch.tensor(values, dtype=torch.float64), q))


def end_to_end(state, records: List[Dict], window_s: float) -> Dict[str, float]:
    return {"serve_p95_ms": _p([r["ms"] for r in records], 0.95)}


def host(records: List[Dict]) -> Dict[str, List[float]]:
    return {"item_ms": [r["ms"] for r in records]}


def spans(state):
    from few_shot_seg_cwt_tpu_torch.episodic import engine as engine_mod

    return [(state["engine"].backbone, "extract_features", "backbone"),
            (engine_mod, "adapt_classifier_batch", "inner_loop"),
            (state["client"], "answer", "request")]


def work(state) -> Dict[str, float]:
    """A request's FLOPs and the inner loop's bound at E = 1."""
    cfg = state["cfg"]
    h = W.feature_side(cfg.image_size)
    k1 = W.inner_loop_work(1, 1, h, h, cfg.bottleneck_dim, cfg.image_size, cfg.image_size,
                           cfg.adapt_iter)
    return {"flops_per_item": W.cwt_episode_flops(state["sd"], state["sd_cwt"], 1,
                                                  cfg.image_size, cfg.layers,
                                                  cfg.num_classes_tr, cfg.bottleneck_dim,
                                                  cfg.adapt_iter),
            "k1_bound_ms": W.bound(*k1)[0]}


def free(state) -> None:
    state.pop("engine", None)
    state.pop("client", None)


def readings(state, records: List[Dict], ctx) -> Dict[str, float]:
    done = sorted({r["request"] for r in records})
    picks = sorted(ctx.rng.sample(done, min(int(ctx.cell.traffic["check_requests"]),
                                            len(done))))
    if not picks:
        return {"mask_gap": float("inf"), "flip_share": float("inf")}
    d = reference_logits(state, picks)
    mask_gap, flip_share = 0.0, 0.0
    for r in records:
        if r["request"] not in picks:
            continue
        d_ref = d[picks.index(r["request"])]
        wrong = (served(state, r) > 0) != (d_ref > 0)
        scale = float(d_ref.abs().median())
        if wrong.any():
            mask_gap = max(mask_gap, float(d_ref[wrong].abs().max()) / scale)
        flip_share = max(flip_share, float(wrong.float().mean()))
    return {"mask_gap": mask_gap, "flip_share": flip_share}


def reference_logits(state, picks: List[int]) -> torch.Tensor:
    """The reference's foreground-minus-background logits of the pool's
    requests ``picks``, (len(picks), H, W) on the host."""
    cfg = state["cfg"]
    idx = torch.tensor(picks, device=state["w0"].device)
    pool = {k: v[idx] for k, v in state["pool"].items()}
    e = len(picks)
    feat, _ = ref_pspnet.features(state["sd"], torch.cat([pool["s_img"][:, 0], pool["q_img"]]),
                                  cfg.layers)
    w = ref_cwt.adapt(feat[:e], pool["s_label"][:, 0], state["w0"][idx], cfg.adapt_iter,
                      cfg.cls_lr)
    with torch.no_grad():
        return ref_cwt.serve_logit_gap(state["sd_cwt"], w, feat[e:],
                                       pool["q_img"].shape[1:3]).cpu()


def control(state, records: List[Dict]) -> None:
    """The reference at TF32 in the program's place: each record's mask
    becomes the lower-precision reference's."""
    picks = sorted({r["request"] for r in records})
    with lower_precision():
        d = reference_logits(state, picks)
    for r in records:
        r["mask"] = (d[picks.index(r["request"])] > 0).int()     # every answer the control's
