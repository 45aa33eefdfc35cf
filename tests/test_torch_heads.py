"""The port's MMN head engine and trainer against the JAX package, on the
CPU: ``HeadEngine`` eval, serve and one train-step gradient at 33 px
(5x5 features) with adapt_iter 5, on both consensus routes (the flat route
runs the pivot pair's plain version on CPU tensors); the head losses; the
optimizers and schedules; and ``train_head.main`` on synthetic episodes.

Weights: the JAX modules' variable trees filled from a numpy seed (BN
fields around identity, non-zero biases), carried to the port by
``utils/convert.py``. Classifier inits: the JAX engine draws them from its
episode keys (``init_classifier_weights``), and the port gets the same
draws as ``w0``. Dropout is off (att_drop = proj_drop = 0) where the two
are compared. Tolerances:

* ``pred``/``pred1``: rtol 1e-2, atol 2e-3 of the logit scale, argmax
  agreement >= 99.5% (the engine tolerance of tests/test_torch_engine.py);
* I/U areas: differ by at most the pixels whose predictions disagree;
  per-episode CE rtol 1e-2;
* head gradients of one episode, under the ``wt_ce`` loss (the config's
  ``wt_dc`` gives exactly 0 here), none of them all zero: rtol 1e-3, atol
  1e-3 of each tensor's largest entry (fp32 backbone features through 50
  layers feed them);
* optimizer trajectories: rtol 1e-5, atol 1e-6 (fp32; Adam applies its
  bias corrections in another order than optax).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from few_shot_seg_cwt_tpu.config import load_cfg as jax_load_cfg
from few_shot_seg_cwt_tpu.config import merge_cfg_from_list as jax_merge
from few_shot_seg_cwt_tpu.episodic.heads import HeadEngine as JaxHeadEngine
from few_shot_seg_cwt_tpu.models.pspnet import init_classifier_weights as jax_init_w
from few_shot_seg_cwt_tpu.ops import losses as jax_losses
from few_shot_seg_cwt_tpu.train.optim import build_optimizer as jax_build_optimizer
from few_shot_seg_cwt_tpu_torch.config import load_cfg, merge_cfg_from_list
from few_shot_seg_cwt_tpu_torch.data.synthetic import make_episode_batch
from few_shot_seg_cwt_tpu_torch.episodic.heads import HeadEngine
from few_shot_seg_cwt_tpu_torch.models.mmn import build_mmn
from few_shot_seg_cwt_tpu_torch.models.pspnet import build_pspnet
from few_shot_seg_cwt_tpu_torch.ops import losses
from few_shot_seg_cwt_tpu_torch.train.optim import build_optimizer
from few_shot_seg_cwt_tpu_torch.utils.convert import (mmn_state_dict_from_flax,
                                                      pspnet_state_dict_from_flax)

torch.set_num_threads(1)

CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "pascal_mmn.yaml")
SIZE, FEAT, E = 33, 5, 2
OPTS = ["image_size", str(SIZE), "adapt_iter", "5", "use_amp", "False",
        "att_drop", "0.0", "proj_drop", "0.0"]
EP_KEYS = ("s_img", "s_label", "q_img", "q_label", "cls")
FLAT_SWITCHES = ("FSS_PIVOT_MXU", "FSS_PIVOT_PALLAS", "FSS_DISABLE_PALLAS", "FSS_NCONS_R4")


@pytest.fixture
def route(request, monkeypatch):
    for var in FLAT_SWITCHES:
        monkeypatch.delenv(var, raising=False)
    if request.param == "flat":
        monkeypatch.setenv("FSS_PIVOT_MXU", "1")
    return request.param


def _cfg(opts=()):
    return merge_cfg_from_list(load_cfg(CONFIG), OPTS + list(opts))


def _seeded_variables(init, rng, he_kernels, *args):
    """A flax module's variables drawn with numpy instead of its initialisers
    (``jax.eval_shape`` gives the tree without compiling the init): conv
    kernels He-normal over fan-out (``he_kernels``, the backbone's init) or
    U(+-1/sqrt(fan_in)) (the head's), BN scale/var in [0.5, 1.5), biases,
    BN means and the classifier N(0, 0.05), the gamma scalar 0.2."""
    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel" and he_kernels:
            return rng.normal(0, np.sqrt(2 / (shape[0] * shape[1] * shape[3])), shape)
        if name == "kernel":
            bound = 1 / np.sqrt(np.prod(shape[:-1]))
            return rng.uniform(-bound, bound, shape)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape)
        if name == "gamma":
            return np.full(shape, 0.2)
        return rng.normal(0, 0.05, shape)

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(leaf(p, s), np.float32), shapes)


@pytest.fixture(scope="module")
def pair():
    """(JAX engine, backbone vars, head params, port engine on the same weights)."""
    jcfg = jax_merge(jax_load_cfg(CONFIG), OPTS)
    jeng = JaxHeadEngine(jcfg, "mmn")
    rng = np.random.default_rng(2021)
    vars_b = _seeded_variables(
        lambda r, x: jeng.backbone.init({"params": r}, x, train=False), rng, True,
        jnp.zeros((1, SIZE, SIZE, 3)))
    feats = {3: [jnp.zeros((1, FEAT, FEAT, 1024))] * 6, 4: [jnp.zeros((1, FEAT, FEAT, 2048))] * 3}
    f = jnp.zeros((1, FEAT, FEAT, 512))
    params = _seeded_variables(jeng.head.init, rng, False, feats, feats, f, f)["params"]

    tcfg = _cfg()
    backbone = build_pspnet(tcfg)
    backbone.load_state_dict(pspnet_state_dict_from_flax(vars_b))
    head = build_mmn(tcfg)
    head.load_state_dict(mmn_state_dict_from_flax(params))
    teng = HeadEngine(tcfg, "mmn", backbone=backbone, head=head, device="cpu")
    return jeng, vars_b, params, teng


@pytest.fixture(scope="module")
def episodes():
    """E episodes (one support partly 255), their JAX keys and the JAX
    classifier-init draw of each key."""
    batch = make_episode_batch(3, E, size=SIZE)
    batch["s_label"][0, 0, :4, :] = 255
    batch = {k: batch[k] for k in EP_KEYS}
    rngs = jax.random.split(jax.random.PRNGKey(5), E)
    w0 = np.stack([np.array(jax_init_w(r, 2, 512)) for r in rngs])
    return batch, rngs, w0


@pytest.fixture(scope="module")
def jax_eval(pair, episodes):
    """JAX eval_metrics_batch, and per episode the deterministic pred/pred1."""
    jeng, vars_b, params, _ = pair
    batch, rngs, _ = episodes
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics = jeng.eval_metrics_batch(params, vars_b, jbatch, rngs, None)

    @jax.jit
    def preds(ep, rng):
        parts = jeng.episode_parts(vars_b, ep, rng)
        return jeng._loss_mmn({"params": params}, parts, ep, rng, det=True)[1]

    per_ep = [preds({k: v[i] for k, v in jbatch.items()}, rngs[i]) for i in range(E)]
    return ({k: np.asarray(v) for k, v in metrics.items()},
            [{k: np.asarray(v) for k, v in p.items()} for p in per_ep])


def _scaled_close(got, ref, rtol, atol_frac):
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol_frac * float(np.abs(ref).max()))


def test_block_features_match_jax(pair):
    """``rmid l34``: extract_features also returns every bottleneck block's
    output of stages 1-4, as the JAX trunk's ``feats`` (rtol 1e-3, atol 1e-4
    of each map's scale: fp32 convolutions summed in another order)."""
    jeng, vars_b, _, teng = pair
    x = np.random.default_rng(4).standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    ref_out, ref_feats = jax.jit(lambda v, i: jeng.backbone.apply(
        v, i, train=False, method=jeng.backbone.extract_features))(vars_b, jnp.asarray(x))
    with torch.no_grad():
        out, feats = teng.backbone.extract_features(torch.from_numpy(x))
    _scaled_close(out.numpy(), np.asarray(ref_out), rtol=1e-3, atol_frac=1e-4)
    assert sorted(feats) == [1, 2, 3, 4]
    for stage in (1, 2, 3, 4):
        assert len(feats[stage]) == len(ref_feats[stage]) == (3, 4, 6, 3)[stage - 1]
        for got, want in zip(feats[stage], ref_feats[stage]):
            _scaled_close(got.numpy(), np.asarray(want), rtol=1e-3, atol_frac=1e-4)


@pytest.mark.parametrize("route", ["flat", "r4"], indirect=True)
def test_eval_predictions_match_jax(pair, episodes, jax_eval, route):
    _, _, _, teng = pair
    batch, _, w0 = episodes
    _, want = jax_eval
    got = teng.predict_batch(batch, w0=torch.from_numpy(w0))
    for i in range(E):
        for key in ("pred1", "pred"):
            g, w = got[key][i].numpy(), want[i][key]
            assert g.shape == w.shape == (SIZE, SIZE, 2)
            _scaled_close(g, w, rtol=1e-2, atol_frac=2e-3)
            assert (g.argmax(-1) == w.argmax(-1)).mean() >= 0.995, (i, key)


@pytest.mark.parametrize("route", ["flat", "r4"], indirect=True)
def test_eval_metrics_batch_matches_jax(pair, episodes, jax_eval, route):
    _, _, _, teng = pair
    batch, _, w0 = episodes
    want, preds = jax_eval
    got = teng.eval_metrics_batch(batch, w0=torch.from_numpy(w0))
    assert np.array_equal(got["cls"].numpy(), batch["cls"])
    port_preds = teng.predict_batch(batch, w0=torch.from_numpy(w0))
    for i in range(E):
        flips = max(int((port_preds[k][i].argmax(-1).numpy() != preds[i][k].argmax(-1)).sum())
                    for k in ("pred", "pred1"))
        for name in ("inter", "union", "inter1", "union1", "inter0", "union0"):
            np.testing.assert_allclose(got[name][i].numpy(), want[name][i], atol=flips,
                                       err_msg=name)
        np.testing.assert_allclose(got["loss"][i].numpy(), want["loss"][i], rtol=1e-2)


@pytest.mark.parametrize("route", ["flat", "r4"], indirect=True)
def test_serve_episode_matches_jax(pair, episodes, jax_eval, route):
    jeng, vars_b, params, teng = pair
    batch, rngs, w0 = episodes
    _, preds = jax_eval
    masks = teng.serve_batch(batch, w0=torch.from_numpy(w0))
    assert masks.shape == (E, SIZE, SIZE) and masks.dtype == torch.int32
    ep = {k: v[1] for k, v in batch.items()}
    one = teng.serve_episode(ep, w0=w0[1]).numpy()
    assert np.array_equal(one, masks[1].numpy())
    if route == "r4":   # the JAX serving program itself, once
        ref = np.asarray(jax.jit(jeng.serve_episode)(
            vars_b, params, {k: jnp.asarray(v) for k, v in ep.items()}, rngs[1]))
        assert np.array_equal(ref, preds[1]["pred"].argmax(-1))
    for i in range(E):
        assert (masks[i].numpy() == preds[i]["pred"].argmax(-1)).mean() >= 0.995


@pytest.fixture(scope="module")
def jax_grads(pair, episodes):
    """jax.grad of the JAX train_episode_loss for episode 0, dropout off,
    under the ``wt_ce`` loss: the config's ``wt_dc`` saturates on these
    weights at 33 px and every head gradient is exactly 0 in both packages."""
    jeng, vars_b, params, _ = pair
    batch, rngs, _ = episodes
    jeng = type(jeng)(jax_merge(jeng.cfg.clone(), ["loss_type", "wt_ce"]), "mmn")
    ep = {k: jnp.asarray(v[0]) for k, v in batch.items()}
    grads = jax.jit(jax.grad(lambda p: jeng.train_episode_loss(p, vars_b, ep, rngs[0])[0]))(
        params)
    # the engine splits the key: the first half draws the classifier init
    w0 = np.array(jax_init_w(jax.random.split(rngs[0])[0], 2, 512))
    return mmn_state_dict_from_flax(jax.tree.map(np.asarray, grads)), w0


@pytest.mark.parametrize("route", ["flat", "r4"], indirect=True)
def test_train_step_gradient_matches_jax(pair, episodes, jax_grads, route, monkeypatch):
    _, _, _, teng = pair
    batch, _, _ = episodes
    want, w0 = jax_grads
    monkeypatch.setitem(teng.cfg, "loss_type", "wt_ce")
    one = {k: v[:1] for k, v in batch.items()}
    metrics = teng.backward_batch(one, w0=torch.from_numpy(w0[None]), deterministic=True)
    assert torch.isfinite(metrics["loss_mean"])
    grads = {k: p.grad for k, p in teng.head.named_parameters()}
    assert sorted(grads) == sorted(want)
    for name, w in want.items():
        w = w.numpy()
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(grads[name].numpy(), w, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(w).max()), err_msg=name)


def test_gradient_accumulation_equals_one_backward(pair, episodes):
    """head_grad_accum (per-episode backward) and one backward over the
    summed losses give the same mean gradient."""
    _, _, _, teng = pair
    batch, _, w0 = episodes
    grads = []
    for accum in (True, False):
        teng.cfg.head_grad_accum = accum
        teng.backward_batch(batch, w0=torch.from_numpy(w0), deterministic=True)
        grads.append({k: p.grad.clone() for k, p in teng.head.named_parameters()})
    teng.cfg.head_grad_accum = True
    for k in grads[0]:
        torch.testing.assert_close(grads[0][k], grads[1][k], rtol=1e-5, atol=1e-8)


def test_train_step_updates_the_head_with_dropout_on():
    cfg = _cfg(["att_drop", "0.5", "proj_drop", "0.5", "adapt_iter", "2"])
    engine = HeadEngine(cfg, "mmn", device="cpu")
    before = {k: p.detach().clone() for k, p in engine.head.named_parameters()}
    opt, sched = build_optimizer(engine.head.parameters(), cfg, base_lr=0.01,
                                 iters_per_epoch=4)
    step = engine.make_train_step(opt, sched)
    batch = make_episode_batch(4, E, size=SIZE)
    for i in range(2):
        metrics = step(batch, torch.Generator().manual_seed(i))
        assert torch.isfinite(metrics["loss_mean"])
        assert metrics["inter1"].shape == (E, 2)
    moved = [k for k, p in engine.head.named_parameters() if not torch.equal(p, before[k])]
    assert "corr_net.NeighConsensus.conv.0.conv1.weight" in moved
    assert any(k.startswith("wa_") for k in moved)


def test_unported_head_paths_raise_naming_the_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        HeadEngine(_cfg(), "chm", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        HeadEngine(_cfg(["meta_aug", "2", "att_type", "0"]), "mmn", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_pspnet(_cfg(["rmid", "nr"]))


# --------------------------------------------------------------------------- #
# losses and optimizers
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("loss_type", ["wt_dc", "ce", "wt_ce"])
def test_seg_loss_matches_jax(loss_type):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((7, 9, 2)).astype(np.float32) * 3
    target = rng.integers(0, 2, (7, 9))
    target[0, :4] = 255
    want = jax_losses.seg_loss(jnp.asarray(logits), jnp.asarray(target), loss_type=loss_type)
    got = losses.seg_loss(torch.from_numpy(logits), torch.from_numpy(target),
                          loss_type=loss_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("opts", [
    dict(main_optim="SGD", scheduler="cosine", nesterov=True),
    dict(main_optim="SGD", scheduler="step", nesterov=False),
    dict(main_optim="Adam", scheduler="multi_step", nesterov=False),
])
def test_optimizer_trajectory_matches_optax(opts):
    """Seven steps on the same gradients: torch.optim + LambdaLR against the
    JAX package's optax chain (weight decay before momentum, schedules
    stepped per iteration)."""
    cfg = _cfg(["epochs", "3", "lr_stepsize", "1", "gamma", "0.5", "milestones", "[1, 2]",
                "weight_decay", "0.01", "momentum", "0.9"])
    for k, v in opts.items():
        cfg[k] = v
    rng = np.random.default_rng(5)
    p0 = rng.standard_normal(6).astype(np.float32)
    grads = rng.standard_normal((7, 6)).astype(np.float32)
    tx = jax_build_optimizer(cfg, base_lr=0.1, iters_per_epoch=2)
    p_jax, state = jnp.asarray(p0), None
    state = tx.init(p_jax)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, sched = build_optimizer([param], cfg, base_lr=0.1, iters_per_epoch=2)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, p_jax)
        p_jax = optax.apply_updates(p_jax, upd)
        param.grad = torch.from_numpy(g.copy())
        opt.step()
        sched.step()
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(p_jax), rtol=1e-5,
                                   atol=1e-6)


# --------------------------------------------------------------------------- #
# the trainer entry point
# --------------------------------------------------------------------------- #


def test_train_head_main_smoke(tmp_path, monkeypatch):
    from few_shot_seg_cwt_tpu_torch.train import train_head

    monkeypatch.chdir(tmp_path)
    cfg = _cfg(["adapt_iter", "2", "synthetic_data", "True", "epochs", "1",
                "iter_per_epoch", "4", "episode_batch", "2", "test_num", "3",
                "save_models", "True"])
    lines = []
    best = train_head.main(cfg, "mmn", device="cpu", log=lines.append)
    assert 0.0 <= best <= 1.0
    assert any(str(line).startswith("val: mIoU") for line in lines)
    saved = list(tmp_path.rglob("final.pt"))
    assert len(saved) == 1
    head = build_mmn(cfg)
    head.load_state_dict(torch.load(saved[0], weights_only=True))
    cfg.synthetic_data = False
    cfg.train_list = "no/such/train.txt"
    with pytest.raises(RuntimeError, match="no/such/train.txt"):
        train_head.main(cfg, "mmn", device="cpu", log=lines.append)
