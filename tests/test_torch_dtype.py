"""The bf16 policy: the port against the JAX package on the CPU (33 px
images -> 5x5 features, adapt_iter 5).

* (d) ``stage_dtype_policy`` parses ``compute_dtype``, ``use_amp`` and
  ``bf16_stages`` as the JAX one does; an unknown stage raises in both.
* (e) bf16 backbone features, whole cast and ``bf16_stages
  stem,layer1,layer2``, against the JAX bf16 features: within 3e-2 of
  max|f|. bf16 keeps 8 bits of mantissa, and XLA's and PyTorch's CPU
  convolutions round their bf16 results at different points, so the two
  drift apart by a few bf16 steps through 50 layers.
* (f) the mixed-policy CWT eval loss within rtol 0.05 of fp32, and closer
  to fp32 than the whole cast's (the JAX property, tests/test_engine.py).
* (g) the ``use_amp`` MMN train step (the head in bf16 at the loss
  boundary, fp32 master weights): finite loss and bf16 correlation volumes
  as in JAX on the port's whole step; then the head alone on the same
  episode parts as JAX's ``use_amp`` step, on each consensus route. The
  parts are JAX's with every feature at unit RMS per channel (the scale BN
  gives a trained backbone) and the classifier rows at norm 4: on the
  seeded backbone's raw features (per-pixel norms in the thousands) the
  logits are near 1e5 and the loss 2.9e5. There the port's bf16 loss lies
  within 1e-4 (relative) of JAX's, where JAX's own bf16 loss lies 9e-4
  from its fp32 one. The bf16 head gradients are rounding-noisy at 33 px
  whatever the pair of implementations: JAX's own lie up to 0.27 (L2,
  relative, per tensor) from its fp32 ones, most of it on the WeightAverage
  attention's theta/phi tensors, whose gradients are 1e-5 to 1e-7 of the
  consensus's. So each tensor is held in two ways, with fixed limits: its
  L2 distance from JAX's bf16 gradient within 0.3 (seen: up to 0.23) and
  its scale <g_port, g_jax> / |g_jax|^2 within [0.8, 1.25] (seen: 0.86 to
  1.04), so a gradient at half or twice its size fails; and the whole head
  gradient as one vector within 5e-2 (seen: 0.013 to 0.036). The port's
  fp32 head on the same parts is JAX's fp32 head within 1e-3 of each
  tensor's largest entry, and its bf16 gradients are not its fp32 ones.
  Also the pivot pair on a bf16 volume against the JAX Pallas wrapper's
  casts, and ``train_head.main`` and ``train_kshot.main`` with ``use_amp
  True``.

Weights are drawn with numpy as in tests/test_torch_kshot.py and carried
by ``utils/convert.py``; the port's bf16 parameters are those fp32 values
rounded to nearest even, as JAX's casts round them.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from few_shot_seg_cwt_tpu.config import default_cfg as jax_default_cfg
from few_shot_seg_cwt_tpu.config import load_cfg as jax_load_cfg
from few_shot_seg_cwt_tpu.config import merge_cfg_from_list as jax_merge
from few_shot_seg_cwt_tpu.episodic.heads import HeadEngine as JaxHeadEngine
from few_shot_seg_cwt_tpu.models import pspnet as jax_pspnet
from few_shot_seg_cwt_tpu.models.pspnet import init_classifier_weights as jax_init_w
from few_shot_seg_cwt_tpu.ops.corr import get_corr as jax_get_corr
from few_shot_seg_cwt_tpu.ops.pallas_pivot_mxu import pivot_conv_flat_mxu as jax_pivot_mxu
from few_shot_seg_cwt_tpu_torch.config import default_cfg, load_cfg, merge_cfg_from_list
from few_shot_seg_cwt_tpu_torch.data.synthetic import make_episode_batch
from few_shot_seg_cwt_tpu_torch.episodic.engine import EpisodicEngine
from few_shot_seg_cwt_tpu_torch.episodic.heads import HeadEngine
from few_shot_seg_cwt_tpu_torch.models import mmn as port_mmn
from few_shot_seg_cwt_tpu_torch.models.mmn import build_mmn
from few_shot_seg_cwt_tpu_torch.models.pspnet import (BACKBONE_STAGES, build_pspnet,
                                                      stage_dtype_policy)
from few_shot_seg_cwt_tpu_torch.ops import corr, cuda_pivot
from few_shot_seg_cwt_tpu_torch.utils.convert import (mmn_state_dict_from_flax,
                                                      pspnet_state_dict_from_flax)
from test_torch_kshot import seeded_variables

torch.set_num_threads(1)

CONFIG_MMN = str(Path(__file__).resolve().parents[1] / "configs" / "pascal_mmn.yaml")
SIZE, FEAT = 33, 5
EP_KEYS = ("s_img", "s_label", "q_img", "q_label", "cls")
MIXED = "stem,layer1,layer2"
FLAT_SWITCHES = ("FSS_PIVOT_MXU", "FSS_PIVOT_PALLAS", "FSS_DISABLE_PALLAS", "FSS_NCONS_R4")


# --------------------------------------------------------------------------- #
# (d) the policy
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("opts", [
    {}, {"compute_dtype": "bfloat16"}, {"use_amp": True}, {"bf16_stages": "stem, layer1"},
    {"bf16_stages": "all"}, {"bf16_stages": "ppm,bottleneck"},
], ids=["float32", "bfloat16", "use_amp", "stem-layer1", "all", "ppm-bottleneck"])
def test_stage_dtype_policy_matches_jax(opts):
    jcfg, tcfg = jax_default_cfg(), default_cfg()
    for k, v in opts.items():
        jcfg[k] = tcfg[k] = v
    want = jax_pspnet.stage_dtype_policy(jcfg)
    got = stage_dtype_policy(tcfg)
    assert tuple(got) == BACKBONE_STAGES == jax_pspnet.BACKBONE_STAGES
    assert {s: str(d).split(".")[-1] for s, d in got.items()} == \
        {s: jnp.dtype(d).name for s, d in want.items()}


def test_stage_dtype_policy_unknown_stage_raises_in_both():
    jcfg, tcfg = jax_default_cfg(), default_cfg()
    jcfg.bf16_stages = tcfg.bf16_stages = "stem,layer9"
    with pytest.raises(AssertionError):
        jax_pspnet.stage_dtype_policy(jcfg)
    with pytest.raises(ValueError, match="layer9"):
        stage_dtype_policy(tcfg)
    with pytest.raises(ValueError, match="float16"):
        stage_dtype_policy(_with(default_cfg(), compute_dtype="float16"))


def _with(cfg, **kv):
    for k, v in kv.items():
        cfg[k] = v
    return cfg


# --------------------------------------------------------------------------- #
# (e) bf16 backbone features
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def cwt_backbone_vars():
    jcfg = _with(jax_default_cfg(), image_size=SIZE)
    backbone = jax_pspnet.build_pspnet(jcfg)
    return seeded_variables(lambda r, x: backbone.init({"params": r}, x, train=False),
                            np.random.default_rng(2021), True, jnp.zeros((1, SIZE, SIZE, 3)))


@pytest.mark.parametrize("policy", [{"compute_dtype": "bfloat16"}, {"bf16_stages": MIXED}],
                         ids=["whole", "mixed"])
def test_bf16_backbone_features_match_jax(cwt_backbone_vars, policy):
    vars_b = cwt_backbone_vars
    jcfg = _with(jax_default_cfg(), image_size=SIZE, **policy)
    tcfg = _with(default_cfg(), image_size=SIZE, **policy)
    jnet = jax_pspnet.build_pspnet(jcfg)
    x = np.random.default_rng(4).standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)

    @jax.jit
    def jax_features(v, imgs):
        v, imgs = jax_pspnet.cast_backbone_io(jax_pspnet.stage_dtype_policy(jcfg), v, imgs)
        return jnet.apply(v, imgs, train=False, method=jnet.extract_features)[0]

    want = np.asarray(jax_features(vars_b, jnp.asarray(x)).astype(jnp.float32))
    net = build_pspnet(tcfg).eval()
    net.load_state_dict(pspnet_state_dict_from_flax(vars_b))
    pol = stage_dtype_policy(tcfg)
    for stage, module in net.stage_modules().items():
        assert {p.dtype for p in module.parameters()} == {pol[stage]}, stage
    assert net.classifier.weight.dtype == net.gamma.dtype == torch.float32
    with torch.no_grad():
        got = net.extract_features(torch.from_numpy(x))
    assert got.dtype == pol["bottleneck"]
    got = got.float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-2 * float(np.abs(want).max()))


# --------------------------------------------------------------------------- #
# (f) the mixed policy in the CWT engine
# --------------------------------------------------------------------------- #


def test_mixed_policy_eval_loss_is_closer_to_fp32_than_the_whole_cast(cwt_backbone_vars):
    base = build_pspnet(_with(default_cfg(), image_size=SIZE))
    base.load_state_dict(pspnet_state_dict_from_flax(cwt_backbone_vars))
    batch = make_episode_batch(6, 4, size=SIZE)
    w0 = EpisodicEngine(_with(default_cfg(), image_size=SIZE), backbone=copy.deepcopy(base),
                        device="cpu").init_weights(4, torch.Generator().manual_seed(2))
    losses = {}
    for name, policy in (("fp32", {}), ("mixed", {"bf16_stages": MIXED}),
                         ("whole", {"compute_dtype": "bfloat16"})):
        cfg = _with(default_cfg(), image_size=SIZE, adapt_iter=5, **policy)
        torch.manual_seed(0)  # the same CWT init in each engine (build_cwt's seed)
        engine = EpisodicEngine(cfg, backbone=copy.deepcopy(base), device="cpu")
        out = engine.eval_metrics_batch(batch, w0=w0)
        losses[name] = out["loss"].numpy()
        assert np.isfinite(losses[name]).all(), name
    np.testing.assert_allclose(losses["mixed"], losses["fp32"], rtol=0.05)
    off = {k: float(np.abs(losses[k] - losses["fp32"]).sum()) for k in ("mixed", "whole")}
    assert off["mixed"] < off["whole"], off


# --------------------------------------------------------------------------- #
# (g) use_amp in the MMN train step
# --------------------------------------------------------------------------- #


# temp 1: at the config's 20 the readout softmax is one-hot on these
# weights (the fp32 readouts of the two packages are equal bit for bit) and
# its gradients are rounding noise; wt_ce: the dice loss saturates at 33 px
# and every head gradient is exactly 0 in both packages
AMP_OPTS = ["image_size", str(SIZE), "adapt_iter", "5", "att_drop", "0.0", "proj_drop", "0.0",
            "temp", "1.0", "loss_type", "wt_ce"]


@pytest.fixture(scope="module")
def amp_pair():
    """(JAX head engine, backbone vars, head params, port engine), the config
    as shipped (``use_amp True``) but dropout off and the ``wt_ce`` loss
    (the dice loss saturates at 33 px: every gradient is 0 in both)."""
    jcfg = jax_merge(jax_load_cfg(CONFIG_MMN), AMP_OPTS)
    assert jcfg.use_amp
    jeng = JaxHeadEngine(jcfg, "mmn")
    rng = np.random.default_rng(2021)
    vars_b = seeded_variables(
        lambda r, x: jeng.backbone.init({"params": r}, x, train=False), rng, True,
        jnp.zeros((1, SIZE, SIZE, 3)))
    feats = {3: [jnp.zeros((1, FEAT, FEAT, 1024))] * 6,
             4: [jnp.zeros((1, FEAT, FEAT, 2048))] * 3}
    f = jnp.zeros((1, FEAT, FEAT, 512))
    params = seeded_variables(jeng.head.init, rng, False, feats, feats, f, f)["params"]
    tcfg = merge_cfg_from_list(load_cfg(CONFIG_MMN), AMP_OPTS)
    backbone = build_pspnet(tcfg)
    backbone.load_state_dict(pspnet_state_dict_from_flax(vars_b))
    head = build_mmn(tcfg)
    head.load_state_dict(mmn_state_dict_from_flax(params))
    teng = HeadEngine(tcfg, "mmn", backbone=backbone, head=head, device="cpu")
    return jeng, vars_b, params, teng


@pytest.fixture(scope="module")
def amp_episode():
    batch = make_episode_batch(3, 1, size=SIZE)
    batch["s_label"][0, 0, :4, :] = 255
    return {k: batch[k] for k in EP_KEYS}, jax.random.PRNGKey(7)


_JAX_AMP = {}
# (g) on unit-scale parts (module docstring): the loss, the whole head
# gradient as one vector, and each tensor's gradient in L2 and in scale
AMP_LOSS_RTOL, AMP_WHOLE_L2, AMP_GRAD_L2, AMP_GRAD_SCALE = 1e-4, 5e-2, 0.3, (0.8, 1.25)


def unit_scale_parts(parts):
    """JAX episode parts with every feature at unit RMS per channel and the
    classifier rows at norm 4, the raw classifier logits recomputed: the
    scale of a trained backbone's features, where the CE's gradient is more
    than bf16 rounding (see the module docstring)."""
    def unit(t):
        return t * jnp.sqrt(t.shape[-1] / jnp.mean(jnp.sum(t ** 2, axis=-1)))

    out = dict(parts, f_s=unit(parts["f_s"]), f_q=unit(parts["f_q"]),
               w=4.0 * parts["w"] / jnp.linalg.norm(parts["w"], axis=-1, keepdims=True))
    for k in ("fs_feats", "fq_feats"):
        out[k] = {s: [unit(t) for t in v] for s, v in parts[k].items()}
    out["pd_q0"] = jnp.einsum("...hwc,kc->...hwk", out["f_q"], out["w"])
    out["pd_s"] = jnp.einsum("...hwc,kc->...hwk", out["f_s"], out["w"])
    return out


def jax_amp_grads(amp_pair, amp_episode, route):
    """JAX's ``train_episode_loss`` loss and gradients with ``use_amp`` on
    and off on the consensus ``route`` (the flat route through the MXU
    Pallas pair in interpret mode), on one set of episode parts: JAX's
    bf16-backbone prologue, brought to unit scale (``unit_scale_parts``)
    and held fixed. The prologue itself (bf16 backbone, 5 inner steps at
    cls_lr 0.1 on random weights) amplifies bf16 rounding, so two bf16
    prologues compare nothing about the head; the backbone is held by (e)
    and by ``f_q`` below."""
    if route in _JAX_AMP:
        return _JAX_AMP[route]
    jeng, vars_b, params, _ = amp_pair
    batch, key = amp_episode
    ep = {k: jnp.asarray(v[0]) for k, v in batch.items()}
    rng_w = jax.random.split(key)[0]
    raw = jax.jit(jeng.episode_parts)(vars_b, ep, rng_w)
    parts = unit_scale_parts(raw)
    losses, grads = {}, {}
    for amp in (True, False):
        fixed = type(jeng)(_with(jeng.cfg.clone(), use_amp=amp), "mmn")
        fixed.episode_parts = lambda *_: parts
        loss, g = jax.jit(jax.value_and_grad(
            lambda p: fixed.train_episode_loss(p, vars_b, ep, key)[0]))(params)
        losses[amp] = float(loss)
        grads[amp] = mmn_state_dict_from_flax(jax.tree.map(np.asarray, g))
    w0 = np.array(jax_init_w(rng_w, 2, 512))
    to_torch = lambda tree: jax.tree.map(lambda t: torch.from_numpy(np.array(t)), tree)  # noqa: E731
    _JAX_AMP[route] = losses, grads, w0, to_torch(raw), to_torch(parts)
    return _JAX_AMP[route]


@pytest.fixture
def route(request, monkeypatch):
    for var in FLAT_SWITCHES:
        monkeypatch.delenv(var, raising=False)
    if request.param == "flat":
        monkeypatch.setenv("FSS_PIVOT_MXU", "1")
        monkeypatch.setenv("FSS_PIVOT_INTERPRET", "1")
    return request.param


@pytest.mark.parametrize("route", ["r4", "flat"], indirect=True)
def test_use_amp_train_step_gradients_match_jax(amp_pair, amp_episode, route, monkeypatch):
    _, _, _, teng = amp_pair
    batch, _ = amp_episode
    jax_losses, jax_grads, w0, raw, parts = jax_amp_grads(amp_pair, amp_episode, route)
    want, fp32 = jax_grads[True], jax_grads[False]
    seen = []

    def recording_get_corr(q, k):
        out = corr.get_corr(q, k)
        seen.append((q.dtype, out.dtype))
        return out

    monkeypatch.setattr(port_mmn, "get_corr", recording_get_corr)
    # the whole step on the port's own bf16 prologue
    metrics = teng.backward_batch(batch, w0=torch.from_numpy(w0[None]), deterministic=True)
    assert torch.isfinite(metrics["loss_mean"]) and metrics["loss_mean"].dtype == torch.float32
    # the head's features and its correlation volumes are bf16, as JAX's
    # get_corr emits them for bf16 features (test_get_corr_and_l2norm_...)
    assert seen and all(d == (torch.bfloat16, torch.bfloat16) for d in seen), seen
    own = teng.episode_parts(teng.to_device(batch), torch.from_numpy(w0[None]))
    want_fq = raw["f_q"].numpy()
    np.testing.assert_allclose(own["f_q"][0].numpy(), want_fq[0], rtol=0,
                               atol=3e-2 * float(np.abs(want_fq).max()))
    # the head on JAX's parts, under the same casts as backward_batch's, and
    # in fp32 (use_amp off) as the witness that the bf16 step ran in bf16
    episode = teng.to_device({k: v[0] for k, v in batch.items()})
    got = {}
    for amp in (False, True):
        teng.cfg.use_amp = amp
        teng.head.zero_grad(set_to_none=True)
        with teng._amp_head():
            loss, _ = teng.train_episode_loss(parts, episode, deterministic=True)
            loss.backward()
        got[amp] = {k: p.grad.numpy().ravel().copy() for k, p in teng.head.named_parameters()}
    assert teng.cfg.use_amp
    assert loss.dtype == torch.float32
    assert float(loss) == pytest.approx(jax_losses[True], rel=AMP_LOSS_RTOL)
    # the masters stay fp32 parameters and take fp32 gradients
    for k, p in teng.head.named_parameters():
        assert isinstance(p, torch.nn.Parameter) and p.dtype == torch.float32, k
        assert p.grad is not None and p.grad.dtype == torch.float32, k
    l2 = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))  # noqa: E731
    rows = {}
    for name, w in want.items():
        w, f = w.numpy().ravel(), fp32[name].numpy().ravel()
        assert np.abs(w).max() > 0, name
        # the port's fp32 head on these parts is JAX's fp32 head (1e-3 as
        # in tests/test_torch_heads.py)
        np.testing.assert_allclose(got[False][name], f, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(f).max()), err_msg=name)
        g = got[True][name]
        rows[name] = (l2(g, w), float(g @ w / (w @ w)), l2(w, f))
    bad = {k: v for k, v in rows.items()
           if not (v[0] <= AMP_GRAD_L2 and AMP_GRAD_SCALE[0] <= v[1] <= AMP_GRAD_SCALE[1])}
    assert not bad, (f"({route}) per tensor: |g_port - g_jax| / |g_jax|, <g_port, g_jax> / "
                     f"|g_jax|^2 and JAX's own bf16 spread |g_jax - g_jax,fp32| / "
                     f"|g_jax,fp32|: {bad}")
    whole = [np.concatenate([d[k].numpy().ravel() if torch.is_tensor(d[k]) else d[k]
                             for k in want]) for d in (got[True], want)]
    print(f"({route}) loss {float(loss)} vs JAX bf16 {jax_losses[True]} / fp32 "
          f"{jax_losses[False]}; per tensor, port vs JAX bf16 in L2 up to "
          f"{max(v[0] for v in rows.values()):.4f}, scale "
          f"{min(v[1] for v in rows.values()):.4f} to {max(v[1] for v in rows.values()):.4f}, "
          f"JAX's bf16 spread up to {max(v[2] for v in rows.values()):.4f}; whole gradient "
          f"{l2(*whole):.4f}")
    assert l2(*whole) <= AMP_WHOLE_L2, (route, l2(*whole))
    assert any(not np.allclose(got[True][k], got[False][k], rtol=1e-3, atol=0)
               for k in got[True]), "the use_amp step gave the fp32 gradients"


def test_gradient_accumulation_equals_one_backward_under_use_amp(amp_pair):
    """``backward_batch`` casts the head to bf16 once for the batch. With
    ``head_grad_accum`` each episode's backward passes through those casts
    in turn, and gives the bits of a fresh cast per episode; one backward
    over the summed losses sums the episodes' bf16 gradients before the
    cast back to fp32, so it agrees to bf16 rounding (2^-8)."""
    _, _, _, teng = amp_pair
    assert teng.cfg.use_amp and teng.cfg.get("head_grad_accum", True)
    batch = {k: v for k, v in make_episode_batch(5, 2, size=SIZE).items() if k in EP_KEYS}
    w0 = torch.from_numpy(np.stack([np.asarray(jax_init_w(k, 2, 512))
                                    for k in jax.random.split(jax.random.PRNGKey(9), 2)]))
    grads = {}
    for accum in (True, False):
        teng.cfg.head_grad_accum = accum
        teng.backward_batch(batch, w0=w0, deterministic=True)
        grads[accum] = {k: p.grad.clone() for k, p in teng.head.named_parameters()}
    teng.cfg.head_grad_accum = True
    # the per-episode casts by hand
    tb = teng.to_device(batch)
    parts = teng.episode_parts(tb, w0)
    teng.head.zero_grad(set_to_none=True)
    for i in range(2):
        with teng._amp_head():
            (teng.train_episode_loss(*teng._one(parts, tb, i), True)[0] / 2).backward()
    for k, p in teng.head.named_parameters():
        assert torch.equal(grads[True][k], p.grad), k
        assert p.grad.abs().max() > 0, k
        torch.testing.assert_close(grads[False][k], grads[True][k], rtol=1e-2,
                                   atol=1e-2 * float(grads[True][k].abs().max()))


@pytest.mark.parametrize("engine", ["cwt", "mmn"])
def test_engines_refuse_a_backbone_cast_to_another_policy(engine):
    """An engine casts the backbone it is given in place. A backbone that an
    earlier engine cast to bf16 raises in an engine of another policy
    (fp32 or mixed) instead of running bf16 there, and passes in an engine
    of the same policy."""
    config = load_cfg(CONFIG_MMN) if engine == "mmn" else default_cfg()
    cfg = _with(config, image_size=SIZE, use_amp=False, compute_dtype="float32")
    make = ((lambda c, b: HeadEngine(c, "mmn", backbone=b, device="cpu")) if engine == "mmn"
            else (lambda c, b: EpisodicEngine(c, backbone=b, device="cpu")))
    backbone = build_pspnet(cfg)
    make(_with(cfg.clone(), compute_dtype="bfloat16"), backbone)
    assert backbone.layer1[0].conv1.weight.dtype == torch.bfloat16
    for other in ({}, {"bf16_stages": MIXED}):
        with pytest.raises(ValueError, match="already runs the stage policy"):
            make(_with(cfg.clone(), **other), backbone)
    assert make(_with(cfg.clone(), compute_dtype="bfloat16"), backbone).backbone is backbone
    assert backbone.layer1[0].conv1.weight.dtype == torch.bfloat16
    fp32 = build_pspnet(cfg)
    assert make(cfg, fp32).backbone.stage_dtypes is None
    assert fp32.layer4[0].conv1.weight.dtype == torch.float32


def test_use_amp_keeps_eval_in_fp32(amp_pair, amp_episode):
    """Eval and serve run the backbone in bf16 and the head in fp32: the
    parts are fp32, and the head's parameters are untouched."""
    _, _, _, teng = amp_pair
    batch, _ = amp_episode
    assert {p.dtype for p in teng.backbone.layer4.parameters()} == {torch.bfloat16}
    parts = teng.episode_parts(teng.to_device(batch), torch.zeros((1, 2, 512)))
    assert parts["f_q"].dtype == torch.float32
    assert all(t.dtype == torch.float32 for v in parts["fq_feats"].values() for t in v)
    preds = teng.predict_batch(batch, w0=torch.zeros((1, 2, 512)))
    assert preds["pred"].dtype == torch.float32
    assert {p.dtype for p in teng.head.parameters()} == {torch.float32}


def test_get_corr_and_l2norm_keep_bf16_as_jax_does():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 4, 3, 16)).astype(np.float32)
    k = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    qb, kb = torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16()
    got = corr.get_corr(qb, kb)
    want = jax_get_corr(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=1e-2)
    assert corr.get_corr(torch.from_numpy(q), torch.from_numpy(k)).dtype == torch.float32
    assert corr.l2norm(qb, dim=-1).dtype == torch.bfloat16


def test_pivot_pair_on_a_bf16_volume_casts_as_the_jax_wrapper():
    """The flat route under ``use_amp``: fp32 kernels (their plain version
    here) between casts. y and the gradients come back bf16 with the values
    of the fp32 computation on the bf16 inputs, as the JAX Pallas wrapper
    gives them (interpret mode)."""
    dims = (4, 3, 3, 5)
    rng = np.random.default_rng(3)
    hq, wq, hs, ws = dims
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((2, 3, hq * wq, hs * ws), (3, 3, 3, 4), (3, 3, 3, 4), (4,), (2, 4, hq * wq, hs * ws))]
    arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in arrs]
    leaves = [torch.tensor(a).bfloat16().requires_grad_(True) for a in arrs[:4]]
    y = cuda_pivot.pivot_conv_flat(*leaves, dims, relu=True)
    assert y.dtype == torch.bfloat16
    ref = cuda_pivot.pivot_conv_flat_reference(*[torch.tensor(a) for a in arrs[:4]], dims,
                                               relu=True)
    assert torch.equal(y, ref.bfloat16())
    (y.float() * torch.tensor(arrs[4])).sum().backward()

    jx = [jnp.asarray(a, jnp.bfloat16) for a in arrs[:4]]
    jy = jax_pivot_mxu(*jx, dims=dims, relu=True, interpret=True)
    assert jy.dtype == jnp.bfloat16
    np.testing.assert_allclose(y.float().detach().numpy(), np.asarray(jy.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)
    jgrads = jax.grad(lambda *a: jnp.sum(jax_pivot_mxu(*a, dims=dims, relu=True,
                                                       interpret=True).astype(jnp.float32)
                                         * arrs[4]), argnums=(0, 1, 2, 3))(*jx)
    for name, leaf, jg in zip(("dx", "dwa", "dwb", "db"), leaves, jgrads):
        assert leaf.grad.dtype == torch.bfloat16 and jg.dtype == jnp.bfloat16, name
        want = np.asarray(jg.astype(jnp.float32))
        np.testing.assert_allclose(leaf.grad.float().numpy(), want, rtol=2e-2,
                                   atol=2e-2 * float(np.abs(want).max()), err_msg=name)


@pytest.mark.parametrize("trainer", ["train_head", "train_kshot"])
def test_trainers_run_with_use_amp(tmp_path, monkeypatch, trainer):
    from few_shot_seg_cwt_tpu_torch.train import train_head, train_kshot

    monkeypatch.chdir(tmp_path)
    cfg = merge_cfg_from_list(load_cfg(CONFIG_MMN), [
        "image_size", str(SIZE), "adapt_iter", "2", "synthetic_data", "True", "epochs", "1",
        "iter_per_epoch", "2", "episode_batch", "1", "test_num", "2",
        "shot", "1" if trainer == "train_head" else "2"])
    assert cfg.use_amp
    lines = []
    if trainer == "train_head":
        best = train_head.main(cfg, "mmn", device="cpu", log=lines.append)
    else:
        best = train_kshot.main(cfg, device="cpu", log=lines.append)
    assert 0.0 <= best <= 1.0
    assert any(str(line).startswith("val: mIoU") for line in lines)


# --------------------------------------------------------------------------- #
# the fp32-vs-bf16 A/B tool
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("stages", [None, MIXED], ids=["whole", "mixed"])
def test_ab_dtype_runs_both_engines_on_the_same_inputs(stages):
    """``eval/ab_dtype.run_ab`` on the CPU at 33 px: sane numbers, and its
    fp32 side is the plain fp32 engine's protocol mIoU on the same episodes
    and inits (the A side is untouched by the B side's cast)."""
    from collections import defaultdict

    from few_shot_seg_cwt_tpu_torch.eval import ab_dtype
    from few_shot_seg_cwt_tpu_torch.eval.validate import (accumulate_fg_iou,
                                                          batch_generator, fg_miou)
    from few_shot_seg_cwt_tpu_torch.train.common import init_backbone, init_cwt

    cfg = _with(default_cfg(), image_size=SIZE, adapt_iter=3, use_amp=True)
    out = ab_dtype.run_ab(cfg, n_episodes=4, e_batch=2, stages=stages, device="cpu",
                          log=lambda *a: None)
    assert out["episodes"] == 4 and out["device"] == "cpu"
    for k in ("miou_fp32", "miou_bf16", "miou_raw_fp32", "miou_raw_bf16", "mask_agreement"):
        assert 0.0 <= out[k] <= 1.0, (k, out[k])
    assert out["mask_agreement"] + out["argmax_flip_rate"] == pytest.approx(1.0)
    cfg32 = _with(cfg.clone(), use_amp=False)
    engine = EpisodicEngine(cfg32, backbone=init_backbone(cfg32, log=lambda *a: None),
                            cwt=init_cwt(cfg32), device="cpu")
    inter, union = defaultdict(float), defaultdict(float)
    for b in range(2):
        w0 = engine.init_weights(2, batch_generator(cfg.manual_seed, 0, b))
        m = engine.eval_metrics_batch(make_episode_batch(seed=b + 1, e=2, size=SIZE), w0=w0)
        accumulate_fg_iou(inter, union, {k: v.numpy() for k, v in m.items()})
    assert out["miou_fp32"] == pytest.approx(fg_miou(inter, union), abs=1e-7)
