"""The port's CHM head against the benchmark's plain reference
(``benchmark/reference/chm.py``: plain torch, fp32, nothing of the port), on
the CPU.

* Weights from the reference's schema (``schema``, ``live_groups``), the
  two biases calibrated by the reference, loaded into ``CHMLearner`` by
  name: the correlation volume, CHM6d and CHM4d (under each value of the
  JAX package's ``FSS_CONV4D_IM2COL``, which the port does not read), the
  readout and the whole head equal the reference's, on non-negative taps
  of side 6 (a 6^4 volume, a 12^4 one for CHM4d).
* ``HeadEngine(cfg, "chm").eval_metrics_batch`` of 2 episodes at 41 px (the
  benchmark cell's configuration, 5 inner steps) equals the reference's
  losses and areas on the same seeded backbone, head and inputs.
* Under a ``torch.profiler`` the head's five ``fss/chm_*`` spans appear once
  an episode and ``conv4d_q`` counts two calls an episode.
* The reference on TF32 operands (``lower_precision``) breaks at least one
  of these tolerances.

Tolerances, each over the largest magnitude of the reference's tensor: the
volume, CHM6d, CHM4d and the readout 1e-5 (fp32 sums of 2048-long dot
products and of up to 9 x 625 taps, in other orders: 2e-7 to 1.2e-6 seen);
the whole head 1e-4 (the softmax at temp 20 turns a 1e-6 change of the
filtered volume into ~20x that in its weights: 1.1e-5 to 1.9e-5 seen); the
engine's losses 1e-5 relative and its areas to the pixel (the 5-step inner
loop and the backbone run in both). At TF32 the volume reads 1.4e-4, CHM6d
5.9e-5 and the head 1.3e-3.
"""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from benchmark.harness import episodes, program
from benchmark.harness.spec import load_cell
from benchmark.harness.weights import make_state
from benchmark.reference import chm as ref_chm
from benchmark.reference import cwt as ref_cwt
from benchmark.reference import pspnet as ref_pspnet
from benchmark.reference.precision import lower_precision
from few_shot_seg_cwt_tpu_torch import ops
from few_shot_seg_cwt_tpu_torch.episodic.heads import HeadEngine, build_chm
from few_shot_seg_cwt_tpu_torch.models import chm as tchm
from few_shot_seg_cwt_tpu_torch.ops.corr import masked_attention_readout, mutual_nn_filter
from few_shot_seg_cwt_tpu_torch.utils import tracing

SIDE, C, CV = 6, 2048, 16
SIZE, STEPS, E = 41, 5, 2
ROUTES = ["q", "qp", "gemm", "loop"]
TOL_PART, TOL_HEAD, TOL_LOSS = 1e-5, 1e-4, 1e-5
SPANS = ("fss/chm_corr", "fss/chm6d", "fss/chm_pool", "fss/chm4d", "fss/chm_readout")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def route(request, monkeypatch):
    monkeypatch.setenv("FSS_CONV4D_IM2COL", request.param)
    return request.param


def _gap(got, want):
    """max |got - want| over max |want|."""
    return float((got - want).abs().max() / want.abs().max())


@pytest.fixture(scope="module")
def parts():
    """Seeded head weights, side-6 taps and support values, the port's
    head with those weights, and the reference's intermediate volumes."""
    gen = torch.Generator().manual_seed(23)
    p = make_state(ref_chm.schema(C, C), gen, "cpu")
    ref_chm.live_groups(p)
    fq = torch.relu(torch.randn((1, SIDE, SIDE, C), generator=gen))
    fs = torch.relu(torch.randn((1, SIDE, SIDE, C), generator=gen))
    v = torch.randn((1, 2 * SIDE, 2 * SIDE, CV), generator=gen)
    ref_chm.calibrate(p, fq, fs)
    head = tchm.CHMLearner(feat_dim=C, in_dim=C)
    head.load_state_dict(p, strict=True)
    with torch.no_grad():
        corr = ref_chm.correlation6d(p, fq, fs)
        pre6 = ref_chm.chm6d(p, corr)
        pooled = ref_chm.pool(pre6)
        pre4 = ref_chm.chm4d(p, pooled)
    return dict(p=p, fq=fq, fs=fs, v=v, head=head, corr=corr, pre6=pre6, pooled=pooled,
                pre4=pre4)


def test_kernel_groups_are_the_programs():
    """Same groups in the same order: the weights' names rely on it."""
    flat = [tuple(((a * 5 + b) * 5 + c) * 5 + d for a, b, c, d in g)
            for g in ref_chm.kernel_groups(5)]
    assert flat == [tuple(g) for g in tchm.kernel_groups(5, "psi")]
    assert len(ref_chm.scale_links()) == 49


def _port_corr(parts):
    convs = [getattr(parts["head"], f"scale_conv_{i}") for i in range(3)]
    return tchm.build_correlation6d(parts["fq"], parts["fs"], tchm.SCALES, convs)


@torch.no_grad()
def test_correlation6d_equals_the_reference(parts):
    got = _port_corr(parts)
    assert got.shape == (1, 3, 3) + (SIDE,) * 4
    assert float(parts["corr"].max()) > 0.5 and float((parts["corr"] == 0).float().mean()) < 0.9
    assert _gap(got, parts["corr"]) < TOL_PART


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@torch.no_grad()
def test_chm6d_equals_the_reference(parts, route):
    got = parts["head"].chm6d(parts["corr"])
    assert _gap(got, parts["pre6"]) < TOL_PART
    # calibrated: the sigmoid sees both sides of 0
    assert float((parts["pre6"] > 0).float().mean()) == pytest.approx(0.5, abs=0.05)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@torch.no_grad()
def test_chm4d_equals_the_reference(parts, route):
    got = parts["head"].chm4d(parts["pooled"][..., None])[..., 0]
    assert _gap(got, parts["pre4"]) < TOL_PART


@torch.no_grad()
def test_readout_equals_the_reference(parts):
    n = (2 * SIDE) ** 2
    corr2d = mutual_nn_filter(F.softplus(parts["pre4"]).reshape(1, n, n))
    got = masked_attention_readout(corr2d, parts["v"], temp=20.0).reshape(parts["v"].shape)
    want = ref_chm.readout(parts["pre4"], parts["v"], 20.0)
    assert _gap(got, want) < TOL_PART


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@torch.no_grad()
def test_whole_head_equals_the_reference(parts, route):
    got = parts["head"](parts["fq"], parts["fs"], parts["v"])
    want = ref_chm.head(parts["p"], parts["fq"], parts["fs"], parts["v"], 20.0)
    assert _gap(got, want) < TOL_HEAD


@torch.no_grad()
def test_the_reference_at_tf32_breaks_a_tolerance(parts):
    """TF32 operands, the nearest precision below fp32: the volume's
    2048-long products move by ~1e-3, far past the tolerance."""
    with lower_precision():
        corr = ref_chm.correlation6d(parts["p"], parts["fq"], parts["fs"])
        pre6 = ref_chm.chm6d(parts["p"], parts["corr"])
        head = ref_chm.head(parts["p"], parts["fq"], parts["fs"], parts["v"], 20.0)
    got = parts["head"](parts["fq"], parts["fs"], parts["v"])
    gaps = (_gap(corr, parts["corr"]), _gap(pre6, parts["pre6"]), _gap(head, got))
    assert gaps[0] > 10 * TOL_PART and gaps[1] > TOL_PART and gaps[2] > TOL_HEAD, gaps


@pytest.fixture(scope="module")
def engine_parts():
    """The benchmark cell's configuration at 41 px and 5 inner steps, its
    seeded backbone (BN calibrated) and head (biases calibrated on a
    seeded episode), two episodes and their classifier inits."""
    cfg = program.port_cfg(load_cell("chm-eval-b4").config, (SIZE, STEPS))
    gen = torch.Generator().manual_seed(31)
    sd = program.backbone_state(cfg, gen, "cpu")
    p = make_state(ref_chm.schema(), gen, "cpu")
    ref_chm.live_groups(p)
    eps = episodes.episodes(gen, E + 1, SIZE, "cpu")
    _, taps = ref_pspnet.features(sd, torch.cat([eps["q_img"][:1], eps["s_img"][:1, 0]]),
                                  cfg.layers, taps=(4,))
    halved = ref_chm.halve(taps[4])
    ref_chm.calibrate(p, halved[:1], halved[1:])
    eps = {k: v[1:] for k, v in eps.items()}
    w0 = episodes.classifier_inits(gen, E, cfg.num_classes_tr, cfg.bottleneck_dim, "cpu")
    head = build_chm(cfg)
    head.load_state_dict(p, strict=True)
    names = {k.replace("classifier.", "classifier.cls.", 1) if k.startswith("classifier.")
             else k: t for k, t in sd.items()}                 # dist cosN's classifier
    engine = HeadEngine(cfg, "chm", backbone=program.pspnet(cfg, names, "cpu"), head=head,
                        device="cpu")
    return dict(cfg=cfg, sd=sd, p=p, eps=eps, w0=w0, engine=engine)


def test_engine_eval_equals_the_reference(engine_parts):
    cfg, eps, w0 = engine_parts["cfg"], engine_parts["eps"], engine_parts["w0"]
    got = engine_parts["engine"].eval_metrics_batch(eps, w0=w0)
    feat, taps = ref_pspnet.features(engine_parts["sd"], torch.cat([eps["s_img"][:, 0],
                                                                    eps["q_img"]]),
                                     cfg.layers, taps=(4,))
    w = ref_cwt.adapt(feat[:E], eps["s_label"][:, 0], w0, STEPS, cfg.cls_lr)
    want = ref_chm.eval_metrics(engine_parts["p"], w, feat[E:], feat[:E], taps[4][E:],
                                taps[4][:E], eps["q_label"], cfg.att_wt, cfg.temp)
    assert float(((got["loss"] - want["loss"]).abs() / want["loss"]).max()) < TOL_LOSS
    for k in ("inter", "union", "inter1", "union1", "inter0", "union0"):
        assert float((got[k] - want[k]).abs().max()) <= 1.0, k
    # the readout matters: pred1 (the readout alone) differs from pred0
    assert not torch.equal(got["inter1"], got["inter0"])


def test_spans_once_an_episode_and_the_route_counted(engine_parts):
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        engine_parts["engine"].eval_metrics_batch(engine_parts["eps"], w0=engine_parts["w0"])
    names = [ev.name for ev in prof.events() if ev.name.startswith("fss/chm")]
    assert {n: names.count(n) for n in SPANS} == dict.fromkeys(SPANS, E)
    assert set(names) == set(SPANS)
    assert ops.launch_counts("conv4d_q", "conv4d_qp", "conv4d_gemm", "conv4d_loop") == {
        "conv4d_q": 2 * E, "conv4d_qp": 0, "conv4d_gemm": 0, "conv4d_loop": 0}
    tracing.reset()
