"""The port's CHM head against the JAX package, on the CPU: ``kernel_groups``,
``CHM4d`` and ``CHM6d`` (the port's one conv4d route against each of the
JAX package's ``FSS_CONV4D_IM2COL`` routes),
``interpolate4d``, ``build_correlation6d``, ``CHMLearner``, the five
keypoint-geometry functions, the ``chm`` ``HeadEngine`` (eval, serve and
the train step's loss and head gradients) on ``configs/pascal_match.yaml``
with ``crm_type chm``, the ``remat_head`` whole-loss checkpoint and
``train_match.main`` with ``crm_type chm``.

Weights: the JAX modules' trees drawn from a numpy seed over the shapes
``jax.eval_shape`` gives, carried to the port by
``utils/convert.py:chm_state_dict_from_flax``; each JAX reference is one
jitted program. The engine runs at 41 px, not 33: CHM halves the tap's
side and doubles it back, so the side must be even (33 px gives 5, 41 px
gives 6). The JAX prologue runs once per episode and its ``_loss_chm`` on
those parts; the port
gets the JAX classifier-init draw of each episode as ``w0``. Tolerances:
module outputs within 1e-4 * max|ref| + 1e-5, gradients within 1e-3 *
max|g|; the engine's predictions (the backbone's and the 5-step inner
loop's rounding in front of them) as the match head's are held: rtol 1e-2,
atol 2e-3 of the logit scale and argmax agreement >= 99.5%.
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
from few_shot_seg_cwt_tpu.models import chm as jchm
from few_shot_seg_cwt_tpu.models.pspnet import init_classifier_weights as jax_init_w
from few_shot_seg_cwt_tpu.ops import geometry as jgeo
from few_shot_seg_cwt_tpu.ops.losses import cross_entropy as jax_ce
from few_shot_seg_cwt_tpu_torch.config import load_cfg, merge_cfg_from_list
from few_shot_seg_cwt_tpu_torch.data.synthetic import make_episode_batch
from few_shot_seg_cwt_tpu_torch.episodic.heads import HeadEngine, build_chm, head_remat_default
from few_shot_seg_cwt_tpu_torch.models import chm as tchm
from few_shot_seg_cwt_tpu_torch.models.pspnet import build_pspnet
from few_shot_seg_cwt_tpu_torch.ops import geometry as tgeo
from few_shot_seg_cwt_tpu_torch.utils.convert import (chm_state_dict_from_flax,
                                                      pspnet_state_dict_from_flax)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MATCH_CONFIG = str(ROOT / "configs" / "pascal_match.yaml")
SIZE, FEAT, E = 41, 6, 2
OPTS = ["image_size", str(SIZE), "adapt_iter", "5", "crm_type", "chm"]
EP_KEYS = ("s_img", "s_label", "q_img", "q_label", "cls")
ROUTES = ["q", "qp", "gemm", "loop"]


@pytest.fixture
def route(request, monkeypatch):
    monkeypatch.setenv("FSS_CONV4D_IM2COL", request.param)
    return request.param


def _fwd_close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()) + 1e-5)


def _grad_close(got, want, name=""):
    want = np.asarray(want)
    assert np.abs(want).max() > 0, name
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                               atol=1e-3 * float(np.abs(want).max()), err_msg=name)


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _drawn(mod, rng, *args):
    """A module's params drawn with numpy over the tree ``jax.eval_shape``
    gives (no init program to compile): conv kernels U(+-1/sqrt(fan_in)),
    CHM group weights |N(0, 1)| * 1e-2 * 4, biases N(0, 0.05)."""
    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":
            return rng.uniform(-1, 1, shape) / np.sqrt(np.prod(shape[:-1]))
        if name.startswith("param_") or name == "weight":
            return np.abs(rng.normal(0, 1, shape)) * 4e-2
        return rng.normal(0, 0.05, shape)

    shapes = jax.eval_shape(mod.init, jax.random.PRNGKey(0), *args)["params"]
    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(leaf(p, s), np.float32), shapes)


def _jax_out_and_grads(mod, params, *args, **kw):
    """The module's output and the gradient of sum(out ** 2) in its params,
    from one jitted program."""
    def f(p):
        out = mod.apply({"params": p}, *args, **kw)
        first = out[0] if isinstance(out, tuple) else out
        return jnp.sum(first ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    return jax.tree.map(np.asarray, out), jax.tree.map(np.asarray, grads)


# --------------------------------------------------------------------------- #
# kernel groups, CHM4d, CHM6d
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("ksz,ktype", [(3, "psi"), (5, "psi"), (5, "iso"), (3, "iso"),
                                       (5, "full")])
def test_kernel_groups_equal_jax(ksz, ktype):
    assert tchm.kernel_groups(ksz, ktype) == jchm.kernel_groups(ksz, ktype)


@pytest.fixture(scope="module", params=["psi", "iso", "full"])
def chm4d_pair(request):
    ktype = request.param
    rng = np.random.default_rng(61)
    x = np.abs(rng.standard_normal((2, 4, 5, 3, 4, 1))).astype(np.float32)
    mod = jchm.CHM4d(ksz=5, ktype=ktype)
    params = _drawn(mod, rng, jnp.asarray(x))
    want, grads = _jax_out_and_grads(mod, params, jnp.asarray(x))
    port = tchm.CHM4d(ksz=5, ktype=ktype)
    port.load_state_dict(_strip(chm_state_dict_from_flax({"chm4d": params}), "chm4d."))
    return x, want, grads, port


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_chm4d_matches_jax(chm4d_pair, route):
    x, want, grads, port = chm4d_pair
    port.zero_grad()
    out = port(torch.from_numpy(x))
    _fwd_close(out, want)
    (out ** 2).sum().backward()
    for name, p in port.named_parameters():
        _grad_close(p.grad, grads[name], name)


@pytest.fixture(scope="module", params=["psi", "iso"])
def chm6d_pair(request):
    ktype = request.param
    rng = np.random.default_rng(62)
    x = np.abs(rng.standard_normal((1, 3, 3, 4, 3, 4, 5))).astype(np.float32)
    mod = jchm.CHM6d(ksz6d=3, ksz4d=5, ktype=ktype)
    params = _drawn(mod, rng, jnp.asarray(x))
    want, grads = _jax_out_and_grads(mod, params, jnp.asarray(x))
    port = tchm.CHM6d(ksz6d=3, ksz4d=5, ktype=ktype)
    port.load_state_dict(_strip(chm_state_dict_from_flax({"chm6d": params}), "chm6d."))
    return x, want, grads, port


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_chm6d_matches_jax(chm6d_pair, route):
    """One conv4d with the block-sparse (5, 5, 5, 5, 9, 9) scale-mixing kernel."""
    x, want, grads, port = chm6d_pair
    port.zero_grad()
    out = port(torch.from_numpy(x))
    _fwd_close(out, want)
    (out ** 2).sum().backward()
    for name, p in port.named_parameters():
        _grad_close(p.grad, grads[name], name)


def test_chm_initialisers_follow_jax():
    """Group weights |N| * 1e-3 * len(group) (* the scale group's size in
    CHM6d), U(+-1/sqrt(fan_in)) scalar biases, a zero bias and |N| weights
    for ktype full, lecun-normal scale convs; the same tree as flax's, and
    the same draw from the same generator."""
    a = tchm.CHMLearner(ktype="psi", feat_dim=16, in_dim=12,
                        generator=torch.Generator().manual_seed(3))
    b = tchm.CHMLearner(ktype="psi", feat_dim=16, in_dim=12,
                        generator=torch.Generator().manual_seed(3))
    for (k, p), (_, q) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(p, q), k
    groups = tchm.kernel_groups(5, "psi")
    lens = torch.tensor([float(len(g)) for g in groups])
    assert (a.chm4d.weight > 0).all() and (a.chm4d.weight / lens).max() < 1e-2
    assert abs(float(a.chm4d.bias.detach())) <= 1 / 25
    assert abs(float(a.chm6d.bias.detach())) <= 1 / np.sqrt(3 * 3 * 5 ** 4)
    for i, sg in enumerate(tchm._scale_groups("psi")):
        w = getattr(a.chm6d, f"param_{i}")
        assert (w > 0).all() and (w / (lens * len(sg))).max() < 1e-2
    conv = a.scale_conv_0.weight
    assert conv.shape == (4, 12, 3, 3)
    assert float(conv.abs().max()) <= 2 / np.sqrt(12 * 9) / 0.8796 + 1e-6
    full = tchm.CHM4d(ktype="full", generator=torch.Generator().manual_seed(0))
    assert float(full.bias.detach()) == 0.0 and (full.weight >= 0).all()
    jtree = jax.eval_shape(jchm.CHMLearner(ktype="psi", feat_dim=16).init, jax.random.PRNGKey(0),
                           jnp.zeros((1, 4, 4, 12)), jnp.zeros((1, 4, 4, 12)),
                           jnp.zeros((1, 8, 8, 6)))["params"]
    want = chm_state_dict_from_flax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), jtree))
    got = a.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k


# --------------------------------------------------------------------------- #
# interpolate4d, the 6D correlation, CHMLearner
# --------------------------------------------------------------------------- #


def test_interpolate4d_matches_jax():
    x = np.random.default_rng(63).standard_normal((2, 3, 4, 4, 3)).astype(np.float32)
    _fwd_close(tchm.interpolate4d(torch.from_numpy(x), 6),
               jchm.interpolate4d(jnp.asarray(x), 6))


def test_build_correlation6d_matches_jax():
    """Three scales (sides 3, 4 and 6 of a side-4 map), 3x3 convs, cosine
    correlations resized back to side 4, clamped at 0."""
    rng = np.random.default_rng(64)
    src, trg = (rng.standard_normal((2, 4, 4, 6)).astype(np.float32) for _ in range(2))
    kernels = [rng.standard_normal((3, 3, 6, 5)).astype(np.float32) * 0.3 for _ in range(3)]
    jconvs = [lambda x, k=k: jax.lax.conv_general_dilated(
        x, jnp.asarray(k), (1, 1), ((1, 1), (1, 1)), dimension_numbers=("NHWC", "HWIO", "NHWC"))
        for k in kernels]
    tconvs = []
    for k in kernels:
        conv = torch.nn.Conv2d(6, 5, 3, padding=1, bias=False)
        conv.weight.data = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
        tconvs.append(conv)
    want = jchm.build_correlation6d(jnp.asarray(src), jnp.asarray(trg), tchm.SCALES, jconvs)
    with torch.no_grad():
        got = tchm.build_correlation6d(torch.from_numpy(src), torch.from_numpy(trg),
                                       tchm.SCALES, tconvs)
    assert got.shape == (2, 3, 3, 4, 4, 4, 4) and float(got.min()) >= 0.0
    _fwd_close(got, want)


@pytest.fixture(scope="module", params=["psi", "iso"])
def learner_pair(request):
    ktype = request.param
    rng = np.random.default_rng(65)
    src, trg = (rng.standard_normal((2, 4, 4, 12)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    mod = jchm.CHMLearner(ktype=ktype, feat_dim=16, temp=20.0)
    jin = [jnp.asarray(a) for a in (src, trg, v)]
    params = _drawn(mod, rng, *jin)
    want = jax.jit(lambda p: mod.apply({"params": p}, *jin, ret_corr=True))(
        jax.tree.map(jnp.asarray, params))
    port = tchm.CHMLearner(ktype=ktype, feat_dim=16, temp=20.0, in_dim=12)
    port.load_state_dict(chm_state_dict_from_flax(params))
    return (src, trg, v), [np.asarray(t) for t in want], port


@pytest.mark.parametrize("route", ["q", "gemm"], indirect=True)
def test_chm_learner_matches_jax(learner_pair, route):
    """The readout and the filtered correlation; the head engine's tests
    hold CHMLearner's gradients."""
    (src, trg, v), want, port = learner_pair
    with torch.no_grad():
        out, corr = port(*(torch.from_numpy(a) for a in (src, trg, v)), ret_corr=True)
    _fwd_close(out, want[0])
    _fwd_close(corr, want[1])


# --------------------------------------------------------------------------- #
# the keypoint geometry
# --------------------------------------------------------------------------- #

IMG = 160
SIDE = IMG // 8


def test_geometry_normalize_roundtrip_matches_jax():
    kps = np.random.default_rng(66).uniform(0, IMG, size=(2, 2, 6)).astype(np.float32)
    kps[0, :, 4:] = -2.0
    got = tgeo.normalize_kps(torch.from_numpy(kps), IMG)
    _fwd_close(got, jgeo.normalize_kps(jnp.asarray(kps), IMG))
    np.testing.assert_array_equal(got.numpy()[0, :, 4:], -2.0)
    _fwd_close(tgeo.unnormalize_kps(got, IMG), jgeo.unnormalize_kps(jnp.asarray(got.numpy()), IMG))


def test_geometry_attentive_indexing_matches_jax():
    kps = np.random.default_rng(67).uniform(-0.9, 0.9, size=(5, 2)).astype(np.float32)
    got = tgeo.attentive_indexing(torch.from_numpy(kps), SIDE, thres=0.1)
    _fwd_close(got, jgeo.attentive_indexing(jnp.asarray(kps), SIDE, thres=0.1))
    np.testing.assert_allclose(got.sum(dim=(1, 2)).numpy(), 1.0, rtol=1e-5)


def test_geometry_gaussian_kernel_matches_jax():
    corr = np.random.default_rng(68).random((2, 7, SIDE * SIDE)).astype(np.float32)
    _fwd_close(tgeo.apply_gaussian_kernel(torch.from_numpy(corr), SIDE),
               jgeo.apply_gaussian_kernel(jnp.asarray(corr), SIDE))


@pytest.mark.parametrize("normalized", [False, True])
def test_geometry_transfer_kps_matches_jax(normalized):
    rng = np.random.default_rng(69)
    conf = rng.random((2, SIDE * SIDE, SIDE * SIDE)).astype(np.float32) * 5
    kps = rng.uniform(20, IMG - 20, size=(2, 2, 5)).astype(np.float32)
    if normalized:
        kps = (kps - IMG // 2) / (IMG // 2)
    n_pts = np.array([5, 3], np.int32)
    want = jgeo.transfer_kps(jnp.asarray(conf), jnp.asarray(kps), jnp.asarray(n_pts), IMG,
                             normalized=normalized)
    got = tgeo.transfer_kps(torch.from_numpy(conf), torch.from_numpy(kps),
                            torch.from_numpy(n_pts), IMG, normalized=normalized)
    _fwd_close(got, want)
    np.testing.assert_array_equal(got.numpy()[1, :, 3:], -2.0)


# --------------------------------------------------------------------------- #
# the chm head engine
# --------------------------------------------------------------------------- #


def _cfg(opts=()):
    return merge_cfg_from_list(load_cfg(MATCH_CONFIG), OPTS + list(opts))


def _seeded_variables(init, rng, he_kernels, *args):
    """A flax module's variables drawn with numpy (``jax.eval_shape`` gives
    the tree without compiling the init): conv kernels He-normal over
    fan-out (the backbone's) or U(+-1/sqrt(fan_in)) (the head's), BN
    scale/var in [0.5, 1.5), CHM group weights |N(0, 0.05)|, biases, BN
    means and the classifier N(0, 0.05)."""
    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel" and he_kernels:
            return rng.normal(0, np.sqrt(2 / (shape[0] * shape[1] * shape[-1])), shape)
        if name == "kernel":
            return rng.uniform(-1, 1, shape) / np.sqrt(np.prod(shape[:-1]))
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape)
        if name.startswith("param_") or name == "weight":
            return np.abs(rng.normal(0, 0.05, shape))
        return rng.normal(0, 0.05, shape)

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(leaf(p, s), np.float32), shapes)


@pytest.fixture(scope="module")
def chm_pair():
    """(JAX engine, head params, port engine, episodes, per-episode JAX
    parts, w0, rngs)."""
    jeng = JaxHeadEngine(jax_merge(jax_load_cfg(MATCH_CONFIG), OPTS), "chm")
    rng = np.random.default_rng(2023)
    vars_b = _seeded_variables(
        lambda r, x: jeng.backbone.init({"params": r}, x, train=False), rng, True,
        jnp.zeros((1, SIZE, SIZE, 3)))
    half = jnp.zeros((1, FEAT // 2, FEAT // 2, 2048))
    params = _seeded_variables(jeng.head.init, rng, False, half, half,
                               jnp.zeros((1, FEAT, FEAT, 512)))["params"]
    tcfg = _cfg()
    backbone = build_pspnet(tcfg)
    backbone.load_state_dict(pspnet_state_dict_from_flax(vars_b, dist=tcfg.dist))
    head = build_chm(tcfg)
    head.load_state_dict(chm_state_dict_from_flax(params))
    teng = HeadEngine(tcfg, "chm", backbone=backbone, head=head, device="cpu")

    batch = make_episode_batch(16, E, size=SIZE)
    batch = {k: batch[k] for k in EP_KEYS}
    rngs = jax.random.split(jax.random.PRNGKey(9), E)
    w0 = np.stack([np.array(jax_init_w(r, 2, 512)) for r in rngs])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    parts_fn = jax.jit(lambda ep, r: jeng.episode_parts(vars_b, ep, r))
    eps = [{k: v[i] for k, v in jbatch.items()} for i in range(E)]
    parts = [parts_fn(eps[i], rngs[i]) for i in range(E)]
    return jeng, params, teng, batch, eps, parts, w0, rngs


@pytest.fixture(scope="module")
def chm_jax(chm_pair):
    """Per episode, from one jitted JAX program: the train loss, its
    gradients (as a port state_dict) and the predictions (CHM's loss is the
    same at eval and in training)."""
    jeng, params, _, _, eps, parts, _, rngs = chm_pair

    def loss(p, part, ep, r):
        return jeng._loss_chm({"params": p}, part, ep, r, det=False)

    fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
    out = []
    for i in range(E):
        (value, preds), grads = fn(jax.tree.map(jnp.asarray, params), parts[i], eps[i], rngs[i])
        out.append((float(value), {k: np.asarray(v) for k, v in preds.items()},
                    chm_state_dict_from_flax(jax.tree.map(np.asarray, grads))))
    return out


def test_chm_eval_and_serve_match_jax(chm_pair, chm_jax):
    """eval_metrics_batch, predict_batch and serve_batch against the JAX
    ``_loss_chm`` on the same parts; eval_episode_tile 2 runs both episodes
    through one batched head call to the same predictions."""
    _, _, teng, batch, eps, _, w0, _ = chm_pair
    want = [preds for _, preds, _ in chm_jax]
    got = teng.predict_batch(batch, w0=torch.from_numpy(w0))
    metrics = teng.eval_metrics_batch(batch, w0=torch.from_numpy(w0))
    masks = teng.serve_batch(batch, w0=torch.from_numpy(w0))
    assert masks.shape == (E, SIZE, SIZE) and masks.dtype == torch.int32
    for i in range(E):
        for key in ("pred1", "pred"):
            g, w = got[key][i].numpy(), want[i][key]
            assert g.shape == w.shape == (SIZE, SIZE, 2)
            np.testing.assert_allclose(g, w, rtol=1e-2, atol=2e-3 * float(np.abs(w).max()))
            assert (g.argmax(-1) == w.argmax(-1)).mean() >= 0.995, (i, key)
        assert (masks[i].numpy() == want[i]["pred"].argmax(-1)).mean() >= 0.995
        ce = float(jax_ce(jnp.asarray(want[i]["pred"]), eps[i]["q_label"]))
        np.testing.assert_allclose(float(metrics["loss"][i]), ce, rtol=1e-2)
    one = teng.serve_episode({k: v[1] for k, v in batch.items()}, w0=w0[1])
    assert torch.equal(one, masks[1])
    teng.cfg.eval_episode_tile = 2
    try:
        tiled = teng.predict_batch(batch, w0=torch.from_numpy(w0))
    finally:
        teng.cfg.eval_episode_tile = 1
    for k in ("pred1", "pred"):
        torch.testing.assert_close(tiled[k], got[k], rtol=1e-5, atol=1e-5)


def test_chm_train_step_loss_and_gradients_match_jax(chm_pair, chm_jax):
    """Each episode's loss and head gradients (whole-loss checkpoint on,
    the CHM default) against jax.grad of the JAX train loss, per tensor
    (within 1e-3 of each tensor's largest entry), save episode 1's two
    scalar bias gradients, held within 1e-2 of their own size: they are
    sums over the whole volume that cancel, and on the very same parts the
    JAX and port fp32 losses put them 0.5% (CHM4d) and 0.1% (CHM6d) apart,
    while every other tensor agrees to 4e-5."""
    _, _, teng, batch, _, _, w0, _ = chm_pair
    assert head_remat_default(teng.cfg, "chm")
    for i, (want_loss, _, want) in enumerate(chm_jax):
        one = {k: v[i:i + 1] for k, v in batch.items()}
        metrics = teng.backward_batch(one, w0=torch.from_numpy(w0[i:i + 1]), deterministic=True)
        np.testing.assert_allclose(float(metrics["loss_mean"]), want_loss, rtol=1e-3)
        got = {k: p.grad for k, p in teng.head.named_parameters()}
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            if i == 1 and name in ("chm4d.bias", "chm6d.bias"):
                np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                           atol=1e-2 * float(w.abs().max()),
                                           err_msg=f"{i} {name}")
            else:
                _grad_close(got[name], w.numpy(), f"{i} {name}")


def test_remat_head_does_not_change_the_chm_gradients(chm_pair):
    """remat_head None (CHM: checkpoint on), True and False give the same
    gradients; None keeps the checkpoint off for the other heads."""
    _, _, teng, batch, _, _, w0, _ = chm_pair
    one = {k: v[1:] for k, v in batch.items()}
    grads = {}
    try:
        for setting in (None, True, False):
            teng.cfg.remat_head = setting
            teng.backward_batch(one, w0=torch.from_numpy(w0[1:]), deterministic=True)
            grads[setting] = {k: p.grad.clone() for k, p in teng.head.named_parameters()}
    finally:
        teng.cfg.remat_head = None
    for setting in (True, False):
        for k, g in grads[None].items():
            torch.testing.assert_close(grads[setting][k], g, rtol=1e-6, atol=0, msg=k)
    cfg = _cfg()
    assert head_remat_default(cfg, "chm") and not head_remat_default(cfg, "match")
    cfg.remat_head = True
    assert head_remat_default(cfg, "detr")
    cfg.remat_head = False
    assert not head_remat_default(cfg, "chm")


def test_chm_needs_an_even_square_tap():
    with pytest.raises(ValueError, match="even side"):
        HeadEngine(_cfg(["image_size", "33", "adapt_iter", "1"]), "chm", device="cpu").serve_batch(
            make_episode_batch(1, 1, size=33), torch.Generator().manual_seed(0))


def test_train_match_chm_main_on_the_cpu(tmp_path, monkeypatch):
    """``crm_type chm``: train_match trains the CHM head, validates and
    saves its state_dict under results/chm_<train_name>/."""
    from few_shot_seg_cwt_tpu_torch.train import train_match

    monkeypatch.chdir(tmp_path)
    lines = []
    best = train_match.main(_cfg(["adapt_iter", "2", "synthetic_data", "True", "epochs", "1",
                                  "iter_per_epoch", "2", "episode_batch", "2", "test_num", "2",
                                  "save_models", "True"]), device="cpu", log=lines.append)
    assert 0.0 <= best <= 1.0
    assert any(str(l).startswith("==> Start training head 'chm'") for l in lines)
    final = next(tmp_path.rglob("results/chm_pascal/**/final.pt"))
    state = torch.load(final, weights_only=True)
    assert "chm6d.param_3" in state and "scale_conv_2.weight" in state
