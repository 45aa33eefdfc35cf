"""The reference against the program at 33 px and 5 inner steps on shared
weights, layer by layer; the control (the reference at TF32) failing each
cell's comparison; and the work arithmetic pinned to the bounds the repo's
card figures use. The reference imports nothing of the program; these
tests may."""

from __future__ import annotations

import random
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import work as W
from benchmark.harness import episodes, program, runner
from benchmark.harness.spec import load_cell
from benchmark.harness.weights import make_state
from benchmark.reference import cwt as ref_cwt
from benchmark.reference import mmn as ref_mmn
from benchmark.reference import pspnet as ref_pspnet
from benchmark.reference.precision import lower_precision, round_tf32
from staged_cells import STAGED, write_staged_json

SIZE, STEPS = 33, 5


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(name):
    return program.port_cfg(load_cell(name).config, (SIZE, STEPS))


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_backbone_and_taps_match_the_program():
    cfg = _cfg("mmn-train-b2")
    gen = torch.Generator().manual_seed(3)
    sd = program.backbone_state(cfg, gen, "cpu")
    eps = episodes.episodes(gen, 2, SIZE, "cpu")
    imgs = torch.cat([eps["s_img"][:, 0], eps["q_img"]])
    feat, taps = ref_pspnet.features(sd, imgs, cfg.layers, taps=(3, 4))
    model = program.pspnet(cfg, sd, "cpu").eval()
    with torch.no_grad():
        got, feats = model.extract_features(imgs)
    assert _rel(got, feat) < 1e-5
    for b in (3, 4):
        assert _rel(feats[b][-1], taps[b]) < 1e-5


def test_inner_loop_and_eval_match_the_program():
    from few_shot_seg_cwt_tpu_torch.episodic.engine import EpisodicEngine
    from few_shot_seg_cwt_tpu_torch.episodic.inner_loop import adapt_classifier_batch
    from few_shot_seg_cwt_tpu_torch.models.cwt import build_cwt

    cfg = _cfg("cwt-eval-b8")
    gen = torch.Generator().manual_seed(4)
    sd = program.backbone_state(cfg, gen, "cpu")
    sd_cwt = make_state(ref_cwt.transformer_schema(cfg.bottleneck_dim), gen, "cpu")
    eps = episodes.episodes(gen, 3, SIZE, "cpu")
    w0 = episodes.classifier_inits(gen, 3, 2, cfg.bottleneck_dim, "cpu")
    feat, _ = ref_pspnet.features(sd, torch.cat([eps["s_img"][:, 0], eps["q_img"]]), cfg.layers)
    w = ref_cwt.adapt(feat[:3], eps["s_label"][:, 0], w0, STEPS, 0.1)
    got = adapt_classifier_batch(feat[:3, None], eps["s_label"], w0, STEPS, 0.1)
    assert _rel(got, w) < 1e-5
    cwt = build_cwt(cfg)
    cwt.load_state_dict(sd_cwt)
    engine = EpisodicEngine(cfg, backbone=program.pspnet(cfg, sd, "cpu"), cwt=cwt, device="cpu")
    out = engine.eval_metrics_batch(eps, w0=w0)
    ref = ref_cwt.eval_metrics(sd_cwt, ref_cwt.adapt(feat[:3], eps["s_label"][:, 0], w0,
                                                     STEPS, cfg.cls_lr), feat[3:], eps["q_label"])
    for k in ("loss", "loss0"):
        assert _rel(out[k], ref[k]) < 1e-5
    for k in ("inter", "union", "inter0", "union0"):
        assert torch.equal(out[k], ref[k])


def test_mmn_loss_and_gradients_match_the_program(monkeypatch):
    from few_shot_seg_cwt_tpu_torch.episodic.heads import HeadEngine
    from few_shot_seg_cwt_tpu_torch.models.mmn import build_mmn

    cell = load_cell("mmn-train-b2")
    for k, v in cell.config["env"].items():
        monkeypatch.setenv(k, v)
    cfg = program.port_cfg(cell.config, (SIZE, STEPS))
    gen = torch.Generator().manual_seed(5)
    sd = program.backbone_state(cfg, gen, "cpu")
    head0 = make_state(ref_mmn.consensus_schema(2), gen, "cpu")
    for name, v in head0.items():
        if name.endswith("bias"):
            v.fill_(0.05)
    eps = episodes.episodes(gen, 2, SIZE, "cpu")
    w0 = episodes.classifier_inits(gen, 2, 2, cfg.bottleneck_dim, "cpu")
    head = build_mmn(cfg)
    head.load_state_dict(head0)
    engine = HeadEngine(cfg, "mmn", backbone=program.pspnet(cfg, sd, "cpu"), head=head,
                        device="cpu")
    out = engine.backward_batch(eps, w0=w0)
    feat, taps = ref_pspnet.features(sd, torch.cat([eps["s_img"][:, 0], eps["q_img"]]),
                                     cfg.layers, taps=(3, 4))
    w = ref_cwt.adapt(feat[:2], eps["s_label"][:, 0], w0, STEPS, cfg.cls_lr)
    live = {k: v.clone().requires_grad_(True) for k, v in head0.items()}
    loss = sum(ref_mmn.episode_loss(live, {b: t[2 + i:3 + i] for b, t in taps.items()},
                                    {b: t[i:i + 1] for b, t in taps.items()}, feat[i:i + 1],
                                    w[i], eps["q_label"][i], (3, 4), cfg.temp)
               for i in range(2)) / 2
    grads = torch.autograd.grad(loss, list(live.values()))
    assert abs(float(out["loss_mean"]) - float(loss.detach())) < 1e-5 * abs(float(loss.detach()))
    params = dict(engine.head.named_parameters())
    for name, g in zip(live, grads):
        assert _rel(params[name].grad, g) < 1e-4, name


@pytest.mark.parametrize("name", ["cwt-eval-b8", "cwt-serve-c1", "mmn-train-b2",
                                  "mmn-ddp4-train"])
def test_the_control_is_not_correct(name, monkeypatch, tmp_path):
    """The reference at TF32 in the program's place fails the cell's limits
    at the tests' size (the card's readings at the cells' size are in
    PERF.md)."""
    cell = (load_cell(name, write_staged_json(tmp_path / "BENCHMARK.json")) if name in STAGED
            else load_cell(name))
    for k, v in cell.config["env"].items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    drv, ctx, state = runner.prepare(cell, 21, "cpu", (SIZE, STEPS))
    records, _ = runner.window(drv, state, 0.5, ctx.device)
    drv.free(state)
    drv.control(state, records)
    ctx.rng = random.Random(21)
    readings = drv.readings(state, records, ctx)
    assert any(readings[k] > cell.limits[k] for k in readings), readings


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0 - 2 ** -12])
    assert torch.equal(round_tf32(x), torch.tensor([1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -3.0]))
    a, b = torch.randn(8, 8), torch.randn(8, 8)
    with lower_precision():
        from benchmark.reference.precision import matmul
        assert torch.equal(matmul(a, b), round_tf32(a) @ round_tf32(b))


def test_work_pins_the_card_bounds():
    k1 = W.inner_loop_work(8, 1, 60, 60, 512, 473, 473, 200)
    assert W.bound(*k1) == (pytest.approx(0.248, abs=5e-4), "operations")
    got = [W.bound(*W.pivot_work(ci, co, 3600, 3600), tensor_cores=True)
           for ci, co in ((2, 10), (10, 10), (10, 1))]
    assert [k for _, k in got] == ["bytes"] * 3
    assert [round(ms, 3) for ms, _ in got] == [0.186, 0.309, 0.170]


@pytest.mark.parametrize("out_size,in_size", [(473, 60), (33, 5), (41, 6), (60, 1), (8, 8)])
def test_interp_nonzeros_counts_the_align_corners_matrix(out_size, in_size):
    eye = torch.eye(in_size, dtype=torch.float64)[:, None]
    m = F.interpolate(eye, size=out_size, mode="linear", align_corners=True)[:, 0]
    assert W.interp_nonzeros(out_size, in_size) == int(np.count_nonzero(m.numpy() > 1e-12))


def test_consensus_calls_of_an_mmn_step():
    calls = W.consensus_calls((2, 10, 10, 1), (60, 60, 60, 60), episodes=2)
    assert len(calls) == 2 * 2 * (3 + 2 + 3)
    assert W.consensus_bound_ms(calls) == pytest.approx(
        4 * (0.18569552 + 0.30949254 + 0.17022090) + 4 * (0.30949254 + 0.17022090)
        + 4 * (0.18569552 + 0.30949254 + 0.17022090), rel=1e-6)


def test_flop_count_of_a_cwt_episode():
    """The reference's count at 473 px (FlopCounterMode on the meta device)
    plus the closed-form inner loop: 650.4 GFLOP an episode."""
    gen = torch.Generator().manual_seed(0)
    sd = make_state(ref_pspnet.schema(), gen, "cpu")
    sd_cwt = make_state(ref_cwt.transformer_schema(), gen, "cpu")
    t0 = time.perf_counter()
    flops = W.cwt_episode_flops(sd, sd_cwt, 1, 473, 50, 2, 512, 200)
    assert flops == pytest.approx(650.39e9, rel=1e-3)
    assert time.perf_counter() - t0 < 60


def _screen_pool(seed=4, n=3):
    cfg = _cfg("cwt-eval-b8")
    gen = torch.Generator().manual_seed(seed)
    sd = program.backbone_state(cfg, gen, "cpu")
    pool = episodes.episodes(gen, n, SIZE, "cpu")
    w0 = episodes.classifier_inits(gen, n, cfg.num_classes_tr, cfg.bottleneck_dim, "cpu")
    return cfg, gen, sd, pool, w0


def _chaotic_rows(rows, calls):
    """The screen's inner loop as if the episodes at ``rows`` of its first
    ``calls`` calls were chaotic: their noisy run's classifier moved by 1%."""
    adapt, seen = episodes._adapt, []

    def fake(f_s, s_label, w0, steps, lr):
        w = adapt(f_s, s_label, w0, steps, lr)
        seen.append(len(w))
        if len(seen) <= calls:
            k = len(w) // 2
            for r in rows:
                w[k + r] = w[k + r] * 1.01
        return w
    return fake


def test_screen_inner_loop_is_the_references():
    cfg, _, sd, pool, w0 = _screen_pool()
    f = ref_pspnet.features(sd, pool["s_img"][:, 0], cfg.layers)[0]
    lab = pool["s_label"][:, 0]
    want = ref_cwt.adapt(f, lab, w0, STEPS, cfg.cls_lr)
    assert _rel(episodes._adapt(f, lab, w0, STEPS, cfg.cls_lr), want) < 1e-5


def test_screen_keeps_a_calm_pool_and_the_seeds_stream():
    cfg, gen, sd, pool, w0 = _screen_pool()
    before, w_before, stream = {k: v.clone() for k, v in pool.items()}, w0.clone(), gen.get_state()
    got, got_w0 = episodes.screened(gen, pool, w0, sd, cfg, "cpu")
    assert all(torch.equal(got[k], before[k]) for k in before)
    assert torch.equal(got_w0, w_before) and torch.equal(gen.get_state(), stream)


def test_screen_draws_a_chaotic_episode_anew(monkeypatch):
    cfg, gen, sd, pool, w0 = _screen_pool()
    before, w_before = {k: v.clone() for k, v in pool.items()}, w0.clone()
    monkeypatch.setattr(episodes, "_adapt", _chaotic_rows([1], calls=1))
    got, got_w0 = episodes.screened(gen, pool, w0, sd, cfg, "cpu")
    for k in before:
        assert got[k].shape == before[k].shape
        assert torch.equal(got[k][[0, 2]], before[k][[0, 2]])
    assert not torch.equal(got["q_img"][1], before["q_img"][1])
    assert torch.equal(got_w0[[0, 2]], w_before[[0, 2]]) and not torch.equal(got_w0[1], w_before[1])


def test_screen_refuses_a_pool_that_stays_chaotic(monkeypatch):
    cfg, gen, sd, pool, w0 = _screen_pool(n=2)
    monkeypatch.setattr(episodes, "_adapt", _chaotic_rows([0], calls=100))
    with pytest.raises(RuntimeError, match="still chaotic"):
        episodes.screened(gen, pool, w0, sd, cfg, "cpu", rounds=2)
