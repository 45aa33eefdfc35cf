"""The port's spans and counters (``utils/tracing.py``), on the CPU at 33 px.

* With no profiler recording, a span is the shared no-op, and the CWT
  engine's eval and serve batches and the MMN train step give the same bits
  as with every span stubbed out, and as under a profiler.
* Under a CPU ``torch.profiler`` the programs leave their ``fss/`` spans in
  the Chrome trace, nested as the engines run them: the tail inside the
  eval batch, the head's backward inside the train step, the consensus in
  the head's forward and (the pivot operator's backward and the per-block
  recompute) in its backward; ``validate_transformer``'s ``profile_dir``
  trace holds them too.
* ``count``/``counts``/``reset`` keep the kernels' launch counts, from any
  thread.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from few_shot_seg_cwt_tpu_torch import ops
from few_shot_seg_cwt_tpu_torch.config import default_cfg, load_cfg, merge_cfg_from_list
from few_shot_seg_cwt_tpu_torch.data.synthetic import make_episode_batch
from few_shot_seg_cwt_tpu_torch.episodic import engine as engine_mod
from few_shot_seg_cwt_tpu_torch.episodic import heads as heads_mod
from few_shot_seg_cwt_tpu_torch.episodic.engine import EpisodicEngine
from few_shot_seg_cwt_tpu_torch.episodic.heads import HeadEngine
from few_shot_seg_cwt_tpu_torch.models.matching import live_consensus
from few_shot_seg_cwt_tpu_torch.utils import tracing

# the package exports functions of these names: the modules by their path
conv4d_mod = importlib.import_module("few_shot_seg_cwt_tpu_torch.models.conv4d")
matching_mod = importlib.import_module("few_shot_seg_cwt_tpu_torch.models.matching")

torch.set_num_threads(1)

SIZE, E = 33, 2
MMN_CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "pascal_mmn.yaml")
MMN_OPTS = ["image_size", str(SIZE), "adapt_iter", "3", "use_amp", "False",
            "att_drop", "0.0", "proj_drop", "0.0", "loss_type", "wt_ce"]
FLAT_SWITCHES = ("FSS_PIVOT_MXU", "FSS_PIVOT_PALLAS", "FSS_DISABLE_PALLAS", "FSS_NCONS_R4")


@pytest.fixture
def flat_route(monkeypatch):
    """The MMN cell's route: the pivot operators (their plain versions on
    CPU tensors) under per-block recompute."""
    for var in FLAT_SWITCHES:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("FSS_PIVOT_MXU", "1")


def _stub_spans(monkeypatch):
    """Every span of the port a plain no-op: the programs as they ran
    before they had spans."""
    off = lambda name: contextlib.nullcontext()  # noqa: E731
    for mod in (engine_mod, heads_mod, matching_mod, conv4d_mod, tracing):
        monkeypatch.setattr(mod, "span", off)


def _cwt_engine():
    cfg = default_cfg()
    cfg.image_size, cfg.adapt_iter = SIZE, 3
    torch.manual_seed(0)
    engine = EpisodicEngine(cfg, device="cpu")
    w0 = engine.init_weights(E, torch.Generator().manual_seed(1))
    return engine, make_episode_batch(3, E, size=SIZE), w0


def _cwt_outputs(engine, episodes, w0):
    out = dict(engine.eval_metrics_batch(episodes, w0=w0))
    out["mask"] = engine.serve_batch(episodes, w0=w0)
    return out


def _mmn_step():
    """A fresh MMN engine's train step on two episodes: its metrics and the
    head's parameters after it."""
    cfg = merge_cfg_from_list(load_cfg(MMN_CONFIG), MMN_OPTS)
    torch.manual_seed(0)
    engine = HeadEngine(cfg, "mmn", device="cpu")
    live_consensus(engine.head)
    w0 = engine.init_weights(E, torch.Generator().manual_seed(1))
    opt = torch.optim.SGD(engine.head.parameters(), lr=0.1, momentum=0.9)
    metrics = engine.make_train_step(opt)(make_episode_batch(5, E, size=SIZE), w0=w0)
    out = {f"m.{k}": v.detach() for k, v in metrics.items()}
    out.update({f"p.{k}": p.detach().clone() for k, p in engine.head.named_parameters()})
    return out


def _profiled(fn):
    """(fn's result, the ``fss/`` spans of its CPU trace as (name, tid,
    start us, end us))."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [(ev.name, ev.thread, ev.time_range.start, ev.time_range.end)
                 for ev in prof.events() if ev.name.startswith(tracing.PREFIX)]


def _assert_same_bits(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _inside(spans, inner, outer):
    """The spans ``inner`` that a span ``outer`` of the same thread holds."""
    outers = [(t, s, e) for n, t, s, e in spans if n == outer]
    return [(s, e) for n, t, s, e in spans if n == inner
            and any(t == ot and os_ <= s and e <= oe for ot, os_, oe in outers)]


def test_a_span_without_a_profiler_is_the_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("tail") is tracing.span("serve")
    with tracing.span("tail"):
        pass


def test_cwt_eval_and_serve_are_the_same_bits_with_spans_off_stubbed_and_recorded(
        monkeypatch):
    engine, episodes, w0 = _cwt_engine()
    spanned = _cwt_outputs(engine, episodes, w0)
    recorded, spans = _profiled(lambda: _cwt_outputs(engine, episodes, w0))
    assert spans
    _stub_spans(monkeypatch)
    _assert_same_bits(spanned, _cwt_outputs(engine, episodes, w0))
    _assert_same_bits(spanned, recorded)


def test_mmn_train_step_is_the_same_bits_with_spans_off_stubbed_and_recorded(
        monkeypatch, flat_route):
    spanned = _mmn_step()
    recorded, spans = _profiled(_mmn_step)
    assert spans
    _stub_spans(monkeypatch)
    stubbed = _mmn_step()
    _assert_same_bits(spanned, stubbed)
    _assert_same_bits(spanned, recorded)


def test_cwt_spans_nest_inside_their_program_call():
    engine, episodes, w0 = _cwt_engine()
    _, spans = _profiled(lambda: engine.eval_metrics_batch(episodes, w0=w0))
    names = {n for n, *_ in spans}
    assert names == {"fss/eval_batch", "fss/stage", "fss/features", "fss/inner_loop",
                     "fss/transform", "fss/tail"}
    assert len([n for n, *_ in spans if n == "fss/eval_batch"]) == 1
    for name in names - {"fss/eval_batch"}:
        assert _inside(spans, name, "fss/eval_batch") == [
            (s, e) for n, _, s, e in spans if n == name], name
    _, spans = _profiled(lambda: engine.serve_batch(episodes, w0=w0))
    assert {n for n, *_ in spans} == {"fss/serve", "fss/stage", "fss/features",
                                      "fss/inner_loop", "fss/transform", "fss/tail"}
    assert len(_inside(spans, "fss/tail", "fss/serve")) == 1
    assert len(_inside(spans, "fss/stage", "fss/serve")) == 2      # episodes, then inits


def test_mmn_train_step_spans_nest_and_the_consensus_runs_in_forward_and_backward(
        flat_route):
    _, spans = _profiled(_mmn_step)
    names = {n for n, *_ in spans}
    assert {"fss/train_step", "fss/stage", "fss/prologue", "fss/features", "fss/inner_loop",
            "fss/head_forward", "fss/head_backward", "fss/optimizer",
            "fss/consensus"} <= names
    for name in ("fss/prologue", "fss/optimizer"):
        assert len(_inside(spans, name, "fss/train_step")) == 1, name
    # head_grad_accum: one forward and one backward an episode
    assert len(_inside(spans, "fss/head_forward", "fss/train_step")) == E
    assert len(_inside(spans, "fss/head_backward", "fss/train_step")) == E
    # forward: the stack, and each of its 2 x 3 centre-pivot blocks, an episode
    fwd = _inside(spans, "fss/consensus", "fss/head_forward")
    assert len(fwd) == E * (1 + 6)
    # backward: each block's recompute and each pivot operator's backward
    bwd = [s for n, t, s, e in spans if n == "fss/consensus"
           and not any(fs == s for fs, _ in fwd)]
    assert len(bwd) == E * 6 * 2


def test_validate_profile_dir_trace_holds_the_engine_spans(tmp_path):
    from few_shot_seg_cwt_tpu_torch.eval.validate import validate_transformer
    from few_shot_seg_cwt_tpu_torch.train.common import episodic_val_loader

    cfg = default_cfg()
    cfg.image_size, cfg.adapt_iter, cfg.synthetic_data = SIZE, 2, True
    cfg.test_num, cfg.n_runs, cfg.episode_batch = 2, 1, 2
    cfg.profile_dir = str(tmp_path / "profile")
    validate_transformer(cfg, EpisodicEngine(cfg, device="cpu"),
                         episodic_val_loader(cfg, device="cpu"), log=lambda *_: None)
    (trace,) = (tmp_path / "profile").glob("validate_transformer.*.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    spans = [ev for ev in events if ev.get("cat") == "user_annotation"
             and ev["name"].startswith(tracing.PREFIX)]
    assert {ev["name"] for ev in spans} == {"fss/eval_batch", "fss/stage", "fss/features",
                                            "fss/inner_loop", "fss/transform", "fss/tail"}
    assert sum(ev["name"] == "fss/eval_batch" for ev in spans) == 1     # one batch


def test_counters_count_snapshot_and_reset():
    tracing.reset()
    assert tracing.counts() == {} and tracing.counts()["pivot_fwd"] == 0
    tracing.count("pivot_fwd")
    tracing.count("pivot_fwd", 2)
    snap = tracing.counts()
    tracing.count("adapt_binary")
    assert snap == {"pivot_fwd": 3}
    assert ops.launch_counts() == {"adapt_binary": 1, "adapt_binary_tiled": 0,
                                   "pivot_fwd": 3, "pivot_dw": 0, "hough4d": 0}
    tracing.reset()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_counters_lose_no_count_across_threads():
    tracing.reset()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [tracing.count("pivot_dw")
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert tracing.counts()["pivot_dw"] == 16 * 2000
    tracing.reset()


def test_kernels_count_no_launch_on_cpu_tensors(flat_route):
    """CPU tensors run the plain versions, uncounted: the MMN step on the
    flat route leaves every kernel's count at 0."""
    tracing.reset()
    out = _mmn_step()
    assert np.isfinite(float(out["m.loss_mean"]))
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
