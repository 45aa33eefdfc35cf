"""The port's attention and transductive heads against the JAX package, on
the CPU: ``CrossAttention`` over ``ln``/``fv``/``fc``/``trans_vn``/``temp``,
``MHA``, ``AttentionBlock`` over ``ld_mode``/``scale_att``/``v_norm``,
``outer_forward`` with ``dot``, ``cos`` and ``cosN``, ``ops/feature_ops.py``,
the ``att`` ``HeadEngine`` (each ``trans_type``, and ``cross_att`` at 3
shots with a padded shot) and the ``asy`` one on configs/pascal_asy.yaml
(eval predictions, the train step's loss and gradients, the refusal to
serve), ``train_att.main`` / ``train_asy.main``, and ``BENCH_HEAD`` att and
asy.

Weights: the JAX modules' trees drawn from a numpy seed over the shapes
``jax.eval_shape`` gives, every LayerNorm field perturbed, carried to the
port by ``utils/convert.py``; each JAX reference is one jitted program.
The engines run at 33 px and adapt_iter 5, one torch thread; the JAX
prologue runs once per episode and its ``_loss_att`` / ``_loss_asy`` on
those parts, the port's engine end to end with the JAX classifier-init
draw of each episode as ``w0``. configs/pascal_asy.yaml reads the ``nr``
tap; the JAX engine cannot map over a feature dict whose keys mix the
stage numbers and ``"nr"`` (``jax.tree.map`` sorts the keys), so its
backbone's taps are cut to that one (``_OneTap``). Tolerances: module outputs within 1e-5 *
max|ref| (gradients of the outputs' squares within 1e-3 * max|g| per
tensor); the engine's predictions within 1e-4 * max|ref|; train-step
gradients (dropout off) within 1e-3 * max|g| per tensor.
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
from few_shot_seg_cwt_tpu.models import att_zoo as jatt
from few_shot_seg_cwt_tpu.models.pspnet import init_classifier_weights as jax_init_w
from few_shot_seg_cwt_tpu.ops import episode_utils as jeu
from few_shot_seg_cwt_tpu.ops import feature_ops as jfo
from few_shot_seg_cwt_tpu.ops.losses import cross_entropy as jax_ce
from few_shot_seg_cwt_tpu_torch.config import load_cfg, merge_cfg_from_list
from few_shot_seg_cwt_tpu_torch.data.synthetic import make_episode_batch
from few_shot_seg_cwt_tpu_torch.episodic.heads import AsyGamma, HeadEngine, build_head
from few_shot_seg_cwt_tpu_torch.models import att_zoo as tatt
from few_shot_seg_cwt_tpu_torch.models.pspnet import build_pspnet
from few_shot_seg_cwt_tpu_torch.ops import episode_utils as teu
from few_shot_seg_cwt_tpu_torch.ops import feature_ops as tfo
from few_shot_seg_cwt_tpu_torch.utils.convert import (asy_state_dict_from_flax,
                                                      att_state_dict_from_flax,
                                                      pspnet_state_dict_from_flax)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ASY_CONFIG = str(ROOT / "configs" / "pascal_asy.yaml")
SIZE, E = 33, 2
OPTS = ["image_size", str(SIZE), "adapt_iter", "5"]
EP_KEYS = ("s_img", "s_label", "q_img", "q_label", "cls")


def _fwd_close(got, want, frac=1e-5):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * float(np.abs(want).max()))


def _grads(module):
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p))
            for k, p in module.named_parameters()}


# a LayerNorm bias on the keys shifts every key's projection alike, which
# the softmax over the keys cancels: its gradient is 0 up to rounding
NULL_GRADS = ("layer_norm_k.bias", "norm1_k.bias")


def _grads_close(got, want, label=""):
    assert sorted(got) == sorted(want)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for name, w in want.items():
        w = np.asarray(w)
        top = float(np.abs(w).max())
        if name in NULL_GRADS:
            assert max(top, float(got[name].abs().max())) <= 1e-5 * scale, name
            continue
        assert top > 0, f"{label} {name}"
        np.testing.assert_allclose(got[name].detach().numpy(), w, rtol=0, atol=1e-3 * top,
                                   err_msg=f"{label} {name}")


def _draw(rng, path, shape):
    """Dense kernels U(+-1/sqrt(fan_in)); every LayerNorm field perturbed
    (scale 1 + N(0, 0.1), bias N(0, 0.1)); the gates and the attention
    scale near their inits; other biases N(0, 0.05)."""
    names = [getattr(k, "key", str(k)) for k in path]
    name = names[-1]
    if name == "kernel":
        return rng.uniform(-1, 1, shape) / np.sqrt(shape[0])
    if name == "scale":
        return 1.0 + rng.normal(0, 0.1, shape)
    if name == "scale_att":
        return 20.0 + rng.normal(0, 1.0, shape)
    if name == "weight":
        return (0.2 if names[0] == "att_wt" else 1.0) + rng.normal(0, 0.05, shape)
    return rng.normal(0, 0.1 if "norm" in names[0] else 0.05, shape)


def _drawn(init, rng, *args):
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)["params"]
    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(_draw(rng, p, s.shape), np.float32), shapes)


def _jax_out_and_grads(mod, params, *args):
    """The module's (output, attention) and the gradient of the sum of
    their squares in its params, from one jitted program."""
    def f(p):
        out = mod.apply({"params": p}, *args)
        return sum(jnp.sum(o ** 2) for o in out), out

    (_, out), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    return jax.tree.map(np.asarray, out), jax.tree.map(np.asarray, grads)


def _tokens(seed, b=2, n_q=7, n_s=9, c=24, cv=16):
    rng = np.random.default_rng(seed)
    k, q = rng.standard_normal((b, n_s, c)), rng.standard_normal((b, n_q, c))
    v, idt = rng.standard_normal((b, n_s, cv)), rng.standard_normal((b, n_q, cv))
    mask = rng.random((b, n_s)) < 0.3
    return [np.asarray(a, np.float32) for a in (k, v, q, idt)] + [mask]


def _module_parity(jmod, tmod, args):
    params = _drawn(jmod.init, np.random.default_rng(31), *[jnp.asarray(a) for a in args])
    want, grads = _jax_out_and_grads(jmod, params, *[jnp.asarray(a) for a in args])
    tmod.load_state_dict(att_state_dict_from_flax(params))
    out = tmod(*[torch.from_numpy(a) for a in args])
    for g, w in zip(out, want):
        _fwd_close(g, w)
    sum((o ** 2).sum() for o in out).backward()
    _grads_close(_grads(tmod), att_state_dict_from_flax(grads))


# --------------------------------------------------------------------------- #
# the attention variants
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("ln,fv,fc,trans_vn,temp", [
    (None, None, None, False, None), ("ln", "fv", "fc", False, None),
    ("ln", None, "fc", True, 0.5), (None, "fv", None, True, None)])
def test_cross_attention_matches_jax(ln, fv, fc, trans_vn, temp):
    """4 heads over 24-wide q/k (dim 32), 16-wide values; the -1000 mask
    repeated per head; the attention map and the LayerNorm'd output."""
    args = _tokens(41)
    kw = dict(n_head=4, dim=32, dim_v=16, ln=ln, fv=fv, fc=fc, temp=temp, trans_vn=trans_vn)
    _module_parity(jatt.CrossAttention(**kw), tatt.CrossAttention(**kw, in_dim=24, v_dim=16),
                   args)


@pytest.mark.parametrize("masked,qkv_bias", [(True, False), (False, True)])
def test_mha_matches_jax(masked, qkv_bias):
    args = _tokens(42)
    if not masked:
        args = args[:4]
    kw = dict(n_head=4, dim=32, dim_v=16, qkv_bias=qkv_bias)
    _module_parity(jatt.MHA(**kw), tatt.MHA(**kw, in_dim=24, v_dim=16), args)


@pytest.mark.parametrize("mode,scale_att,v_norm", [
    ("l", "sc", False), ("ld", "sc", "vn"), ("l", "none", True), ("ld", "none", False)])
def test_attention_block_matches_jax(mode, scale_att, v_norm):
    args = _tokens(43)
    kw = dict(dim=32, dim_v=16, v_norm=v_norm, mode=mode, scale_att=scale_att)
    tmod = tatt.AttentionBlock(**kw, in_dim=24)
    assert tmod.att_wt.weight.shape == (() if mode == "l" else (16,))
    assert hasattr(tmod, "scale_att") == (scale_att == "sc")
    _module_parity(jatt.AttentionBlock(**kw), tmod, args)


def test_attention_block_initialisers_follow_jax():
    """qk_fc: identity plus N(0, 1e-3) noise over the flax (in, out) kernel,
    zero bias; scale 20; gates 0.2 and 1.0; a generator fixes the draw."""
    a, b = (tatt.AttentionBlock(dim=12, dim_v=4, mode="ld", in_dim=8,
                                generator=torch.Generator().manual_seed(3)) for _ in range(2))
    assert torch.equal(a.qk_fc.weight, b.qk_fc.weight)
    w = a.qk_fc.weight.detach()
    assert w.shape == (12, 8)
    assert float((w - torch.eye(8, 12).T).abs().max()) < 0.01
    assert float(a.qk_fc.bias.detach().abs().max()) == 0.0
    assert float(a.scale_att.detach()) == 20.0
    assert torch.equal(a.att_wt.weight.detach(), torch.full((4,), 0.2))
    assert torch.equal(a.org_wt.weight.detach(), torch.ones(4))


def test_build_attention_variant_follows_trans_type():
    cfg = merge_cfg_from_list(load_cfg(ASY_CONFIG), OPTS)
    for t, cls in (("cross_att", tatt.CrossAttention), ("mha", tatt.MHA),
                   ("att_blk", tatt.AttentionBlock)):
        cfg.trans_type = t
        assert isinstance(build_head(cfg, "att"), cls)
    cfg.trans_type = "other"
    with pytest.raises(ValueError, match="unknown trans_type"):
        build_head(cfg, "att")
    ca = tatt.CrossAttention(n_head=2, dim=8, dim_v=4, in_dim=18)
    assert ca.temperature == 9 ** -0.5     # q's width over the heads, not dim's


# --------------------------------------------------------------------------- #
# outer_forward and the feature ops
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dist", ["dot", "cos", "cosN"])
def test_outer_forward_matches_jax(dist):
    rng = np.random.default_rng(44)
    b, h, c, c2, size = 2, 6, 8, 16, 41
    f_q, f_s = (rng.standard_normal((b, h, h, c)).astype(np.float32) for _ in range(2))
    fq_fea, fs_fea = (np.abs(rng.standard_normal((b, h, h, c2))).astype(np.float32)
                      for _ in range(2))
    s_label = rng.integers(0, 2, (b, size, size)).astype(np.int32)
    s_label[0, :5] = 255
    q_label = rng.integers(0, 2, (b, size, size)).astype(np.int32)
    q_label[1, -6:] = 255
    pd_q0, pd_s = (rng.standard_normal((b, h, h, 2)).astype(np.float32) for _ in range(2))
    args = (f_q, f_s, fq_fea, fs_fea, s_label, q_label, pd_q0, pd_s)
    want = jeu.outer_forward(*[jnp.asarray(a) for a in args], jnp.asarray(0.3), temp=20.0,
                             dist=dist)
    got = teu.outer_forward(*[torch.from_numpy(a) for a in args], torch.tensor(0.3),
                            temp=20.0, dist=dist)
    _fwd_close(got[0], want[0])
    _fwd_close(got[1], want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].any() and not got[2].all()


def test_feature_ops_match_jax():
    rng = np.random.default_rng(45)
    x = rng.standard_normal((30, 6)).astype(np.float32) @ np.diag([5, 4, 3, 2, 1, 0.5]).astype(
        np.float32)
    got, want = tfo.pca(torch.from_numpy(x), 3).numpy(), np.asarray(jfo.pca(jnp.asarray(x), 3))
    for j in range(3):   # a component's sign is the SVD's choice
        sign = np.sign(np.dot(got[:, j], want[:, j]))
        np.testing.assert_allclose(got[:, j] * sign, want[:, j], rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))
    np.testing.assert_array_equal(tfo.generate_location_features((4, 7)),
                                  jfo.generate_location_features((4, 7)))
    w = rng.standard_normal((8, 3)).astype(np.float32)
    _fwd_close(tfo.normalized_conv_weights(torch.from_numpy(w)),
               jfo.normalized_conv_weights(jnp.asarray(w)))
    logits = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    for fg in (0, 3):
        _fwd_close(tfo.get_binary_logits(torch.from_numpy(logits), fg),
                   jfo.get_binary_logits(jnp.asarray(logits), fg))


# --------------------------------------------------------------------------- #
# the att and asy head engines
# --------------------------------------------------------------------------- #


def _seeded_backbone(init, rng, *args):
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


class _OneTap:
    """A JAX backbone whose ``extract_features`` keeps one tap: the JAX
    engine's ``jax.tree.map`` over {1, 2, 3, 4, "nr"} fails to sort the
    keys."""

    def __init__(self, backbone, key):
        self._backbone, self._key = backbone, key

    def __getattr__(self, name):
        return getattr(self._backbone, name)

    def apply(self, *args, **kwargs):
        feat, feats = self._backbone.apply(*args, **kwargs)
        return feat, {self._key: feats[self._key]}


_SETUPS = {}


def _setup(shot):
    """The backbone, episodes, per-episode JAX parts, w0 and rngs at ``shot``
    shots (at 3, episode 0's last shot is an all-255 pad), shared by the
    variants."""
    if shot in _SETUPS:
        return _SETUPS[shot]
    extra = ["shot", str(shot)]
    jeng = JaxHeadEngine(jax_merge(jax_load_cfg(ASY_CONFIG), OPTS + extra), "asy")
    jeng.backbone = _OneTap(jeng.backbone, "nr")
    rng = np.random.default_rng(2024)
    vars_b = _seeded_backbone(lambda r, x: jeng.backbone.init({"params": r}, x, train=False),
                              rng, jnp.zeros((1, SIZE, SIZE, 3)))
    batch = make_episode_batch(17 + shot, E, size=SIZE, shot=shot)
    batch = {k: batch[k] for k in EP_KEYS}
    if shot > 1:
        batch["s_label"][0, shot - 1] = 255
    rngs = jax.random.split(jax.random.PRNGKey(10), E)
    w0 = np.stack([np.array(jax_init_w(r, 2, 512)) for r in rngs])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    parts_fn = jax.jit(lambda ep, r: jeng.episode_parts(vars_b, ep, r))
    eps = [{k: v[i] for k, v in jbatch.items()} for i in range(E)]
    parts = [parts_fn(eps[i], rngs[i]) for i in range(E)]
    _SETUPS[shot] = (vars_b, batch, eps, parts, w0, rngs, extra)
    return _SETUPS[shot]


def _port_engine(head_type, extra, vars_b, state):
    cfg = merge_cfg_from_list(load_cfg(ASY_CONFIG), OPTS + extra)
    backbone = build_pspnet(cfg)
    backbone.load_state_dict(pspnet_state_dict_from_flax(vars_b, dist=cfg.dist))
    head = build_head(cfg, head_type)
    head.load_state_dict(state)
    return HeadEngine(cfg, head_type, backbone=backbone, head=head, device="cpu")


@pytest.fixture(scope="module", params=["cross_att", "mha", "att_blk", "cross_att-3shot",
                                        "asy"])
def head_pair(request):
    """(port engine, per-episode JAX (loss, preds, grads as a port
    state_dict), episodes, w0)."""
    name = request.param
    shot = 3 if name.endswith("3shot") else 1
    vars_b, batch, eps, parts, w0, rngs, extra = _setup(shot)
    head_type = "asy" if name == "asy" else "att"
    if head_type == "att":
        extra = extra + ["trans_type", name.split("-")[0]]
    jeng = JaxHeadEngine(jax_merge(jax_load_cfg(ASY_CONFIG), OPTS + extra), head_type)
    if head_type == "asy":
        params = np.float32(0.35)
        to_port = asy_state_dict_from_flax

        def loss(p, part, ep, r):
            return jeng._loss_asy(p, part, ep, r, det=True)
    else:
        key = jeng.cfg.rmid
        p0 = parts[0]
        fq, fs = p0["fq_feats"][key][-1], p0["fs_feats"][key][-1]
        _, h, w, dk = fq.shape
        args = (fs.reshape(1, -1, dk), p0["f_s"].reshape(1, -1, 512), fq.reshape(1, h * w, dk),
                p0["f_q"].reshape(1, h * w, -1), None)
        params = _drawn(jeng.head.init, np.random.default_rng(2025), *args)
        if not jeng.cfg.get("ln"):
            # the seeded backbone's tap has an RMS of ~30: q.k logits of
            # ~5000 would saturate the softmax and leave the projection a
            # gradient at rounding level; a kernel 1/RMS as large keeps
            # the logits O(1)
            params["qk_fc"]["kernel"] /= float(np.sqrt(np.mean(np.square(fq))))
        to_port = att_state_dict_from_flax

        def loss(p, part, ep, r):
            return jeng._loss_att({"params": p}, part, ep, r, det=True)

    fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
    want = []
    for i in range(E):
        (value, preds), grads = fn(jax.tree.map(jnp.asarray, params), parts[i], eps[i], rngs[i])
        want.append((float(value), {k: np.asarray(v) for k, v in preds.items()},
                     to_port(jax.tree.map(np.asarray, grads))))
    teng = _port_engine(head_type, extra, vars_b, to_port(params))
    return teng, want, batch, w0


def test_att_and_asy_eval_matches_jax(head_pair):
    """The eval path's predictions (``_predict_batch``) and
    ``eval_metrics_batch``'s CE against the JAX loss on the same parts."""
    teng, want, batch, w0 = head_pair
    preds = [p for _, _, p in teng._predict_batch(teng.to_device(batch), torch.from_numpy(w0))]
    metrics = teng.eval_metrics_batch(batch, w0=torch.from_numpy(w0))
    for i, (_, jp, _) in enumerate(want):
        for key in ("pred1", "pred"):
            assert preds[i][key].shape == (SIZE, SIZE, 2)
            _fwd_close(preds[i][key], jp[key], 1e-4)
        ce = float(jax_ce(jnp.asarray(jp["pred"]), np.asarray(batch["q_label"][i])))
        np.testing.assert_allclose(float(metrics["loss"][i]), ce, rtol=1e-4)


def test_att_and_asy_train_step_matches_jax(head_pair):
    """Each episode's loss and head gradients (dropout off, the JAX w0)
    against jax.grad of the JAX loss, per tensor."""
    teng, want, batch, w0 = head_pair
    for i, (want_loss, _, grads) in enumerate(want):
        one = {k: v[i:i + 1] for k, v in batch.items()}
        metrics = teng.backward_batch(one, w0=torch.from_numpy(w0[i:i + 1]), deterministic=True)
        np.testing.assert_allclose(float(metrics["loss_mean"]), want_loss, rtol=1e-4)
        _grads_close(_grads(teng.head), grads, label=str(i))


def test_att_and_asy_refuse_to_serve(head_pair):
    teng, _, batch, w0 = head_pair
    with pytest.raises(ValueError, match="no label-free serving form"):
        teng.serve_batch(batch, w0=torch.from_numpy(w0))
    with pytest.raises(ValueError, match="no label-free serving form"):
        teng.serve_episode({k: v[0] for k, v in batch.items()}, w0=w0[0])


def test_asy_trains_a_standalone_gamma():
    cfg = merge_cfg_from_list(load_cfg(ASY_CONFIG), OPTS)
    head = build_head(cfg, "asy")
    assert isinstance(head, AsyGamma) and float(head.gamma.detach()) == pytest.approx(0.2)
    assert list(head.state_dict()) == ["gamma"]


# --------------------------------------------------------------------------- #
# entry points
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name,extra", [("att", ["trans_type", "mha"]), ("asy", [])])
def test_train_att_and_asy_main_on_the_cpu(name, extra, tmp_path, monkeypatch):
    """The alias trainers train their head on synthetic episodes, validate
    and save its state_dict under results/<head>_<train_name>/."""
    import importlib

    trainer = importlib.import_module(f"few_shot_seg_cwt_tpu_torch.train.train_{name}")
    monkeypatch.chdir(tmp_path)
    lines = []
    cfg = merge_cfg_from_list(load_cfg(ASY_CONFIG), [
        "image_size", str(SIZE), "adapt_iter", "2", "synthetic_data", "True", "epochs", "1",
        "iter_per_epoch", "2", "episode_batch", "2", "test_num", "2", "save_models", "True",
        "workers", "0"] + extra)
    best = trainer.main(cfg, device="cpu", log=lines.append)
    assert 0.0 <= best <= 1.0
    assert any(str(l).startswith(f"==> Start training head '{name}'") for l in lines)
    state = torch.load(next(tmp_path.rglob(f"results/{name}_pascal/**/final.pt")),
                       weights_only=True)
    assert ("norm1_v.weight" in state) if name == "att" else (list(state) == ["gamma"])


@pytest.mark.parametrize("head", ["att", "asy"])
def test_bench_att_and_asy_head_modes_run_on_the_cpu(head):
    """BENCH_HEAD att / asy: the MMN knobs, as the JAX bench runs any other
    head; their serve mode raises (the prediction reads the query label)."""
    from few_shot_seg_cwt_tpu_torch.tools import bench

    for mode in ("head", "head_eval"):
        out = bench.run(mode, device="cpu", image_size=SIZE, adapt_iter=2, batches=1,
                        episode_batch=2, quiet=1, head=head)
        assert out["mode"] == mode and np.isfinite(out["value"]) and out["value"] > 0
        assert out["flops_per_episode"] > 0 and out["kernel_launches"] == {}
    with pytest.raises(ValueError, match="no label-free serving form"):
        bench.run("head_serve", device="cpu", image_size=SIZE, adapt_iter=2, batches=1,
                  episode_batch=2, quiet=1, head=head)
