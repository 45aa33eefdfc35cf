"""The port's DeTr head against the JAX package, on the CPU:
``grid_sample_bilinear``, the sine and learned positional encodings,
``MSDeformAttn`` (one and two levels) and ``DeformAtt``, the ``DeTr``
module with ``sf_att`` off and on, the ``detr`` ``HeadEngine`` (eval,
serve and the train step's loss and head gradients) on
``configs/pascal_trans.yaml`` as shipped and with ``sf_att True``, against
the JAX package's rank-4 and flat consensus routes, and
``train_trans.main``.

Weights: the JAX modules' trees drawn from a numpy seed over the shapes
``jax.eval_shape`` gives (sampling-offset biases N(0, 1), so the sampled
points fall between pixels and off the map; positive consensus biases, a
zero-bias random consensus can be dead), carried to the port by
``utils/convert.py:detr_state_dict_from_flax``; each JAX reference is one
jitted program. The engine runs at 33 px and adapt_iter 5; the JAX
prologue runs once per episode and its ``_loss_detr`` on those parts (on
its default rank-4 route), the port's under each JAX switch, with the JAX
classifier-init draw of each episode as ``w0``; the port runs the pivot
pair's plain version on CPU tensors. Tolerances: module outputs
within 1e-4 * max|ref| + 1e-5, gradients within 1e-3 * max|g| (episode 1
of the engine: of the head gradient's largest entry); the engine's
predictions as the match head's: rtol 1e-2, atol 2e-3 of the logit scale
and argmax agreement >= 99.5%.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from few_shot_seg_cwt_tpu.config import load_cfg as jax_load_cfg
from few_shot_seg_cwt_tpu.config import merge_cfg_from_list as jax_merge
from few_shot_seg_cwt_tpu.episodic.heads import HeadEngine as JaxHeadEngine
from few_shot_seg_cwt_tpu.models import deform as jdef
from few_shot_seg_cwt_tpu.models.detr import DeTr as JaxDeTr
from few_shot_seg_cwt_tpu.models.pspnet import init_classifier_weights as jax_init_w
from few_shot_seg_cwt_tpu.ops.losses import cross_entropy as jax_ce
from few_shot_seg_cwt_tpu_torch.config import load_cfg, merge_cfg_from_list
from few_shot_seg_cwt_tpu_torch.data.synthetic import make_episode_batch
from few_shot_seg_cwt_tpu_torch.episodic.heads import HeadEngine, build_head
from few_shot_seg_cwt_tpu_torch.models import deform as tdef
from few_shot_seg_cwt_tpu_torch.models.detr import DeTr
from few_shot_seg_cwt_tpu_torch.models.pspnet import build_pspnet
from few_shot_seg_cwt_tpu_torch.utils import tracing
from few_shot_seg_cwt_tpu_torch.utils.convert import (detr_state_dict_from_flax,
                                                      pspnet_state_dict_from_flax)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TRANS_CONFIG = str(ROOT / "configs" / "pascal_trans.yaml")
SIZE, FEAT, E = 33, 5, 2
OPTS = ["image_size", str(SIZE), "adapt_iter", "5"]
EP_KEYS = ("s_img", "s_label", "q_img", "q_label", "cls")
SWITCHES = ("FSS_PIVOT_MXU", "FSS_PIVOT_PALLAS", "FSS_DISABLE_PALLAS", "FSS_NCONS_R4")


@pytest.fixture
def route(request, monkeypatch):
    """The JAX package's route: "flat" (FSS_PIVOT_MXU=1) or "r4" (its
    default); the port reads neither and runs the pivot kernels."""
    for var in SWITCHES:
        monkeypatch.delenv(var, raising=False)
    if request.param == "flat":
        monkeypatch.setenv("FSS_PIVOT_MXU", "1")
    return request.param


def _fwd_close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()) + 1e-5)


def _grads(module):
    """Every parameter's gradient, zeros where none reached it."""
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p))
            for k, p in module.named_parameters()}


def _grads_close(got, want, per_tensor=True, label=""):
    assert sorted(got) == sorted(want)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for name, w in want.items():
        w = np.asarray(w)
        top = float(np.abs(w).max()) if per_tensor else scale
        if name.endswith("level_embed"):   # used with more than one level only
            assert float(np.abs(w).max()) == 0.0 and float(got[name].abs().max()) == 0.0
            continue
        assert top > 0, name
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-3 if per_tensor else 0,
                                   atol=1e-3 * top, err_msg=f"{label} {name}")


def _draw(rng, path, shape):
    names = [getattr(k, "key", str(k)) for k in path]
    name = names[-1]
    if name == "kernel":
        return rng.uniform(-1, 1, shape) / np.sqrt(np.prod(shape[:-1]))
    if name == "bias" and "sampling_offsets" in names:
        return rng.normal(0, 1.0, shape)
    if name == "bias" and "ncons" in names:
        return rng.uniform(0.05, 0.15, shape)
    if name in ("level_embed", "row_embed", "col_embed"):
        return rng.uniform(0, 1, shape)
    return rng.normal(0, 0.05, shape)


def _drawn(init, rng, *args):
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)["params"]
    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(_draw(rng, p, s.shape), np.float32), shapes)


def _jax_out_and_grads(mod, params, *args, **kw):
    """The module's output and the gradient of the sum of its outputs'
    squares in its params, from one jitted program."""
    def f(p):
        out = mod.apply({"params": p}, *args, **kw)
        outs = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o ** 2) for o in outs if o is not None), out

    (_, out), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    return jax.tree.map(np.asarray, out), jax.tree.map(np.asarray, grads)


def _linear_sd(params, prefix):
    return {f"{prefix}{n}.{leaf}": torch.from_numpy(
        np.array(v["kernel"].T if leaf == "weight" else v["bias"]))
        for n, v in params.items() for leaf in ("weight", "bias")}


# --------------------------------------------------------------------------- #
# sampling and position codes
# --------------------------------------------------------------------------- #


def test_grid_sample_bilinear_matches_jax():
    """Zeros padding and align_corners=False, points inside, between and off
    the map, with a leading grid shape of two axes."""
    rng = np.random.default_rng(71)
    v = rng.standard_normal((2, 7, 9, 3)).astype(np.float32)
    g = rng.uniform(-1.3, 1.3, size=(2, 5, 4, 2)).astype(np.float32)
    got = tdef.grid_sample_bilinear(torch.from_numpy(v), torch.from_numpy(g))
    assert got.shape == (2, 5, 4, 3)
    _fwd_close(got, jdef.grid_sample_bilinear(jnp.asarray(v), jnp.asarray(g)))


@pytest.mark.parametrize("normalize", [True, False])
def test_sine_positional_encoding_matches_jax(normalize):
    mask = np.zeros((2, 6, 7), np.int32)
    mask[1, :2] = 1
    mask[1, :, 5:] = 1
    got = tdef.sine_positional_encoding(torch.from_numpy(mask), 8, normalize=normalize)
    _fwd_close(got, jdef.sine_positional_encoding(jnp.asarray(mask), 8, normalize=normalize))


def test_learned_positional_encoding_matches_jax():
    mod = jdef.LearnedPositionalEncoding(num_feats=6, row_num_embed=9, col_num_embed=8)
    mask = jnp.zeros((2, 5, 7), jnp.int32)
    params = _drawn(mod.init, np.random.default_rng(72), mask)
    port = tdef.LearnedPositionalEncoding(6, 9, 8)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    _fwd_close(port(torch.zeros((2, 5, 7))), mod.apply({"params": params}, mask))
    a, b = (tdef.LearnedPositionalEncoding(6, generator=torch.Generator().manual_seed(1))
            for _ in range(2))
    assert torch.equal(a.row_embed, b.row_embed)
    assert 0.0 <= float(a.col_embed.detach().min()) and float(a.col_embed.detach().max()) < 1.0


# --------------------------------------------------------------------------- #
# deformable attention
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("levels", [[(4, 5)], [(4, 5), (2, 3)]])
def test_ms_deform_attn_matches_jax(levels):
    """Forward and parameter gradients, one level and two."""
    rng = np.random.default_rng(73)
    n, lq, c = 2, 7, 16
    lin = sum(h * w for h, w in levels)
    query = rng.standard_normal((n, lq, c)).astype(np.float32)
    ref = rng.uniform(0, 1, (n, lq, len(levels), 2)).astype(np.float32)
    flat = rng.standard_normal((n, lin, c)).astype(np.float32)
    mod = jdef.MSDeformAttn(d_model=c, n_levels=len(levels), n_heads=4, n_points=3)
    jin = [jnp.asarray(a) for a in (query, ref, flat)]
    params = _drawn(lambda r, *a: mod.init(r, *a, levels), rng, *jin)
    want, grads = _jax_out_and_grads(mod, params, *jin, levels)
    port = tdef.MSDeformAttn(c, len(levels), 4, 3)
    port.load_state_dict(_linear_sd(params, ""))
    out = port(*(torch.from_numpy(a) for a in (query, ref, flat)), levels)
    _fwd_close(out, want)
    (out ** 2).sum().backward()
    _grads_close(_grads(port), _linear_sd(grads, ""))


def test_ms_deform_attn_initialisers_follow_jax():
    """xavier-uniform value/output projections, zero offset and attention
    kernels, the reference's grid as the offset bias, zero biases."""
    port = tdef.MSDeformAttn(32, 1, 8, 9, generator=torch.Generator().manual_seed(0))
    mod = jdef.MSDeformAttn(d_model=32, n_levels=1, n_heads=8, n_points=9)
    x = jnp.zeros((1, 4, 32))
    jp = jax.jit(lambda: mod.init(jax.random.PRNGKey(0), x, jnp.zeros((1, 4, 1, 2)), x,
                                  [(2, 2)]))()["params"]
    np.testing.assert_array_equal(port.sampling_offsets.bias.detach().numpy(),
                                  np.asarray(jp["sampling_offsets"]["bias"]))
    for name in ("sampling_offsets", "attention_weights"):
        assert float(getattr(port, name).weight.detach().abs().max()) == 0.0
    bound = np.sqrt(6 / 64)
    for name in ("value_proj", "output_proj"):
        w = getattr(port, name).weight.detach()
        assert float(w.abs().max()) <= bound and float(w.std()) > bound / 3
        assert float(getattr(port, name).bias.detach().abs().max()) == 0.0


def test_deform_att_matches_jax():
    rng = np.random.default_rng(74)
    fq = rng.standard_normal((2, 4, 5, 16)).astype(np.float32)
    f_q = rng.standard_normal((2, 4, 5, 16)).astype(np.float32)
    mod = jdef.DeformAtt(embed_dims=16, n_heads=8, n_points=9, n_levels=1)
    params = _drawn(mod.init, rng, jnp.asarray(fq), jnp.asarray(f_q))
    want, grads = _jax_out_and_grads(mod, params, jnp.asarray(fq), jnp.asarray(f_q))
    sd = {"level_embed": torch.from_numpy(params["level_embed"]),
          **_linear_sd(params["self_trans"], "self_trans.")}
    port = tdef.DeformAtt(16, 8, 9, 1)
    port.load_state_dict(sd)
    out = port(torch.from_numpy(fq), torch.from_numpy(f_q))
    _fwd_close(out, want)
    (out ** 2).sum().backward()
    _grads_close(_grads(port), {"level_embed": grads["level_embed"],
                                **_linear_sd(grads["self_trans"], "self_trans.")})


# --------------------------------------------------------------------------- #
# the DeTr module
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("sf_att", [False, True])
def test_detr_module_matches_jax(sf_att):
    """l34 taps of 12 and 20 channels reduced to 16; (blended f_q, sa_fq,
    ca_fq) and the gradients of their squares."""
    rng = np.random.default_rng(75 + sf_att)
    feats = [{3: [rng.standard_normal((1, 4, 4, 12)).astype(np.float32)],
              4: [rng.standard_normal((1, 4, 4, 20)).astype(np.float32)]} for _ in range(2)]
    f_q, f_s = (rng.standard_normal((1, 4, 4, 16)).astype(np.float32) for _ in range(2))
    mod = JaxDeTr(rmid="l34", reduce_dim=16, sf_att=sf_att, temp=20.0, att_wt=0.3,
                  block_remat=False)
    jin = [jax.tree.map(jnp.asarray, a) for a in (feats[0], feats[1], f_q, f_s)]
    params = _drawn(mod.init, rng, *jin)
    want, grads = _jax_out_and_grads(mod, params, *jin)
    port = DeTr(rmid="l34", reduce_dim=16, sf_att=sf_att, temp=20.0, att_wt=0.3,
                block_remat=False, in_dim=32)
    port.load_state_dict(detr_state_dict_from_flax(params))
    tin = [jax.tree.map(torch.from_numpy, a) for a in (feats[0], feats[1], f_q, f_s)]
    out = port(*tin)
    assert (out[1] is None) == (not sf_att) and out[2] is not None
    for g, w in zip(out, want):
        if w is not None:
            _fwd_close(g, w)
    sum((o ** 2).sum() for o in out if o is not None).backward()
    _grads_close(_grads(port), detr_state_dict_from_flax(grads))


def test_detr_channel_dropout_is_shared_over_the_map():
    """``drop``: one Bernoulli(0.5) draw a channel and episode, scaled by 2,
    the same at every pixel; off when deterministic."""
    torch.manual_seed(0)
    port = DeTr(rmid="l4", reduce_dim=8, drop=True, in_dim=6)
    x = torch.rand(3, 4, 5, 6) + 0.1
    plain = port.adjust_feature(x, deterministic=True)
    out = port.adjust_feature(x, deterministic=False)
    ratio = torch.where(plain > 0, out / plain, torch.full_like(plain, float("nan")))
    for b in range(3):
        for c in range(8):
            vals = ratio[b, ..., c][~torch.isnan(ratio[b, ..., c])]
            assert vals.numel() == 0 or torch.allclose(vals, vals[0].expand_as(vals))
            assert vals.numel() == 0 or float(vals[0].detach()) in (0.0, 2.0)


# --------------------------------------------------------------------------- #
# the detr head engine
# --------------------------------------------------------------------------- #


def _cfg(opts=()):
    return merge_cfg_from_list(load_cfg(TRANS_CONFIG), OPTS + list(opts))


def _seeded_backbone(init, rng, *args):
    """Backbone variables drawn with numpy: conv kernels He-normal over
    fan-out, BN scale/var in [0.5, 1.5), the rest N(0, 0.05)."""
    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":
            return rng.normal(0, np.sqrt(2 / (shape[0] * shape[1] * shape[-1])), shape)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape)
        return rng.normal(0, 0.05, shape)

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(leaf(p, s), np.float32), shapes)


@pytest.fixture(scope="module")
def detr_setup():
    """The backbone, episodes, per-episode JAX parts, w0 and rngs shared by
    both sf_att settings."""
    jcfg = jax_merge(jax_load_cfg(TRANS_CONFIG), OPTS)
    jeng = JaxHeadEngine(jcfg, "detr")
    rng = np.random.default_rng(2024)
    vars_b = _seeded_backbone(lambda r, x: jeng.backbone.init({"params": r}, x, train=False),
                              rng, jnp.zeros((1, SIZE, SIZE, 3)))
    batch = make_episode_batch(17, E, size=SIZE)
    batch = {k: batch[k] for k in EP_KEYS}
    rngs = jax.random.split(jax.random.PRNGKey(10), E)
    w0 = np.stack([np.array(jax_init_w(r, 2, 512)) for r in rngs])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    parts_fn = jax.jit(lambda ep, r: jeng.episode_parts(vars_b, ep, r))
    eps = [{k: v[i] for k, v in jbatch.items()} for i in range(E)]
    parts = [parts_fn(eps[i], rngs[i]) for i in range(E)]
    return vars_b, batch, eps, parts, w0, rngs


@pytest.fixture(scope="module", params=[False, True], ids=["shipped", "sf_att"])
def detr_pair(request, detr_setup):
    """(port engine, per-episode JAX (loss, preds, grads as a port
    state_dict), episodes, w0) for configs/pascal_trans.yaml as shipped or
    with sf_att True."""
    vars_b, batch, eps, parts, w0, rngs = detr_setup
    extra = ["sf_att", "True"] if request.param else []
    jeng = JaxHeadEngine(jax_merge(jax_load_cfg(TRANS_CONFIG), OPTS + extra), "detr")
    params = _drawn(jeng.head.init, np.random.default_rng(2025 + request.param),
                    parts[0]["fq_feats"], parts[0]["fs_feats"], parts[0]["f_q"], parts[0]["f_s"])

    def loss(p, part, ep, r):
        return jeng._loss_detr({"params": p}, part, ep, r, det=True)

    fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
    want = []
    for i in range(E):
        (value, preds), grads = fn(jax.tree.map(jnp.asarray, params), parts[i], eps[i], rngs[i])
        want.append((float(value), {k: np.asarray(v) for k, v in preds.items()},
                     detr_state_dict_from_flax(jax.tree.map(np.asarray, grads))))
    tcfg = _cfg(extra)
    backbone = build_pspnet(tcfg)
    backbone.load_state_dict(pspnet_state_dict_from_flax(vars_b, dist=tcfg.dist))
    head = build_head(tcfg, "detr")
    head.load_state_dict(detr_state_dict_from_flax(params))
    teng = HeadEngine(tcfg, "detr", backbone=backbone, head=head, device="cpu")
    return teng, want, batch, w0


@pytest.mark.parametrize("route", ["r4", "flat"], indirect=True)
def test_detr_eval_and_serve_match_jax(detr_pair, route):
    """eval_metrics_batch, predict_batch and serve_batch against the JAX
    ``_loss_detr`` on the same parts; the flat route runs the pivot pair
    (its plain version here: no launch is counted on CPU tensors)."""
    teng, want, batch, w0 = detr_pair
    before = tracing.counts()
    got = teng.predict_batch(batch, w0=torch.from_numpy(w0))
    metrics = teng.eval_metrics_batch(batch, w0=torch.from_numpy(w0))
    masks = teng.serve_batch(batch, w0=torch.from_numpy(w0))
    assert tracing.counts() == before
    assert masks.shape == (E, SIZE, SIZE) and masks.dtype == torch.int32
    for i, (_, preds, _) in enumerate(want):
        for key in ("pred1", "pred"):
            g, w = got[key][i].numpy(), preds[key]
            assert g.shape == w.shape == (SIZE, SIZE, 2)
            np.testing.assert_allclose(g, w, rtol=1e-2, atol=2e-3 * float(np.abs(w).max()))
            assert (g.argmax(-1) == w.argmax(-1)).mean() >= 0.995, (i, key)
        assert (masks[i].numpy() == preds["pred"].argmax(-1)).mean() >= 0.995
        ce = float(jax_ce(jnp.asarray(preds["pred"]), np.asarray(batch["q_label"][i])))
        np.testing.assert_allclose(float(metrics["loss"][i]), ce, rtol=1e-2)
    one = teng.serve_episode({k: v[1] for k, v in batch.items()}, w0=w0[1])
    assert torch.equal(one, masks[1])


@pytest.mark.parametrize("route", ["r4", "flat"], indirect=True)
def test_detr_train_step_loss_and_gradients_match_jax(detr_pair, route):
    """Each episode's loss and head gradients against jax.grad of the JAX
    train loss: episode 0 per tensor, episode 1 against the head
    gradient's largest entry."""
    teng, want, batch, w0 = detr_pair
    for i, (want_loss, _, grads) in enumerate(want):
        one = {k: v[i:i + 1] for k, v in batch.items()}
        metrics = teng.backward_batch(one, w0=torch.from_numpy(w0[i:i + 1]), deterministic=True)
        np.testing.assert_allclose(float(metrics["loss_mean"]), want_loss, rtol=1e-3)
        _grads_close(_grads(teng.head), grads, per_tensor=i == 0, label=str(i))


def test_train_trans_main_on_the_cpu(tmp_path, monkeypatch):
    """train_trans trains the DeTr head (sf_att on, channel dropout on),
    validates and saves its state_dict under results/detr_<train_name>/."""
    from few_shot_seg_cwt_tpu_torch.train import train_trans

    monkeypatch.chdir(tmp_path)
    lines = []
    best = train_trans.main(_cfg(["adapt_iter", "2", "synthetic_data", "True", "epochs", "1",
                                  "iter_per_epoch", "2", "episode_batch", "2", "test_num", "2",
                                  "save_models", "True", "sf_att", "True", "drop", "True"]),
                            device="cpu", log=lines.append)
    assert 0.0 <= best <= 1.0
    assert any(str(l).startswith("==> Start training head 'detr'") for l in lines)
    state = torch.load(next(tmp_path.rglob("results/detr_pascal/**/final.pt")),
                       weights_only=True)
    assert "adjust.weight" in state and "self_trans.self_trans.value_proj.weight" in state
    assert "cross_trans.NeighConsensus.conv.4.conv2.bias" in state
