"""The port's CWT meta-training against the JAX package, on the CPU, and its
trainer entry points (33 px images -> 5x5 features, adapt_iter 5).

* One train step against JAX, dropout off: the JAX engine gets a CWT with
  both dropouts at 0 and ``cfg.dropout = 0``; the port gets each episode's
  classifier init as the JAX step draws it (``split(rng, E)``, then
  ``split(., 3)[1]``, then ``init_classifier_weights``). Per-episode losses
  rtol 1e-3; I/U areas within the pixels whose predictions disagree; the
  transformer's gradients of the mean episode loss rtol 1e-3, atol 1e-3 of
  each tensor's largest entry (fp32 backbone features through 50 layers
  and 5 inner steps feed them: the engine tests hold the features to 1e-3).
* Dropout on (port only): the loss falls over SGD steps on a fixed batch,
  and the same generator state gives the same step bit for bit.
* ``train_cwt.main`` and ``train_head.main``: checkpoints, exact resume
  (``resume_ckpt`` and ``auto_resume``) and ``train.test`` reading
  ``best.pth``.

Weights: the JAX package's own init, every BN and LayerNorm field perturbed
by seeded numpy noise, carried over by ``utils/convert.py``.
"""

import functools
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from few_shot_seg_cwt_tpu.config import default_cfg as jax_default_cfg
from few_shot_seg_cwt_tpu.episodic.engine import EpisodicEngine as JaxEngine
from few_shot_seg_cwt_tpu.models.cwt import MultiHeadAttentionOne as JaxCWT
from few_shot_seg_cwt_tpu.models.pspnet import init_classifier_weights as jax_init_w
from few_shot_seg_cwt_tpu.train.optim import build_optimizer as jax_build_optimizer
from few_shot_seg_cwt_tpu_torch.config import default_cfg, load_cfg, merge_cfg_from_list
from few_shot_seg_cwt_tpu_torch.data.synthetic import make_episode_batch
from few_shot_seg_cwt_tpu_torch.episodic.engine import EpisodicEngine
from few_shot_seg_cwt_tpu_torch.models.cwt import MultiHeadAttentionOne
from few_shot_seg_cwt_tpu_torch.models.pspnet import build_pspnet
from few_shot_seg_cwt_tpu_torch.train.optim import build_optimizer
from few_shot_seg_cwt_tpu_torch.utils.ckpt import is_full_train_state, load_ckpt
from few_shot_seg_cwt_tpu_torch.utils.convert import (cwt_state_dict_from_flax,
                                                      pspnet_state_dict_from_flax)

torch.set_num_threads(1)

SIZE, FEAT, E = 33, 5, 3
EP_KEYS = ("s_img", "s_label", "q_img", "q_label", "cls")


def _perturb_norms(tree, rng):
    for node in tree.values():
        if not isinstance(node, dict):
            continue
        if "scale" in node:
            node["scale"] = node["scale"] * rng.uniform(0.5, 1.5, node["scale"].shape).astype(np.float32)
            node["bias"] = node["bias"] + rng.normal(0, 0.1, node["bias"].shape).astype(np.float32)
        if "mean" in node:
            node["mean"] = node["mean"] + rng.normal(0, 0.1, node["mean"].shape).astype(np.float32)
            node["var"] = node["var"] * rng.uniform(0.5, 1.5, node["var"].shape).astype(np.float32)
        _perturb_norms(node, rng)
    return tree


def _set_sizes(cfg, dropout):
    cfg.image_size, cfg.adapt_iter, cfg.cls_lr, cfg.dropout = SIZE, 5, 0.1, dropout
    return cfg


@pytest.fixture(scope="module")
def pair():
    """(JAX engine and variables, port engine on the same weights), every
    dropout off."""
    jcfg = _set_sizes(jax_default_cfg(), 0.0)
    jeng = JaxEngine(jcfg, cwt=JaxCWT(dropout=0.0, attn_dropout=0.0))
    rng = np.random.default_rng(2021)
    vars_b = jax.jit(lambda r, x: jeng.backbone.init({"params": r}, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    vars_b = _perturb_norms(jax.tree.map(lambda x: np.array(x, np.float32), vars_b), rng)
    f = jnp.zeros((1, FEAT, FEAT, 512))
    vars_t = jax.jit(lambda r: jeng.cwt.init(r, jnp.zeros((1, 2, 512)), f, f))(
        jax.random.PRNGKey(1))
    vars_t = _perturb_norms(jax.tree.map(lambda x: np.array(x, np.float32), vars_t), rng)

    tcfg = _set_sizes(default_cfg(), 0.0)
    backbone = build_pspnet(tcfg)
    backbone.load_state_dict(pspnet_state_dict_from_flax(vars_b))
    cwt = MultiHeadAttentionOne(dropout=0.0, attn_dropout=0.0)
    cwt.load_state_dict(cwt_state_dict_from_flax(vars_t))
    teng = EpisodicEngine(tcfg, backbone=backbone, cwt=cwt, device="cpu")
    return jeng, vars_b, vars_t, teng


@pytest.fixture(scope="module")
def episodes():
    """E episodes (one support partly 255), the JAX step's per-episode keys
    and the classifier init each key draws."""
    batch = {k: v for k, v in make_episode_batch(12, E, size=SIZE).items() if k in EP_KEYS}
    batch["s_label"][0, 0, :4, :] = 255
    rngs = jax.random.split(jax.random.PRNGKey(7), E)
    w0 = np.stack([np.array(jax_init_w(jax.random.split(r, 3)[1], 2, 512)) for r in rngs])
    return batch, rngs, w0


@pytest.fixture(scope="module")
def jax_step(pair, episodes):
    """The JAX train step's per-episode losses and metrics and the gradient
    of their mean, with the step's own key split."""
    jeng, vars_b, vars_t, _ = pair
    batch, rngs, _ = episodes
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    extra = {k: v for k, v in vars_t.items() if k != "params"}

    def mean_loss(params):
        losses, metrics = jax.vmap(
            functools.partial(jeng.train_episode_loss, with_metrics=True),
            in_axes=(None, None, None, 0, 0))(params, extra, vars_b, jbatch, rngs)
        return jnp.mean(losses), (losses, metrics)

    (_, (losses, metrics)), grads = jax.jit(jax.value_and_grad(mean_loss, has_aux=True))(
        vars_t["params"])
    return (np.asarray(losses), {k: np.asarray(v) for k, v in metrics.items()},
            cwt_state_dict_from_flax({"params": jax.tree.map(np.asarray, grads)}))


def test_train_step_matches_jax_with_dropout_off(pair, episodes, jax_step):
    _, _, _, teng = pair
    batch, _, w0 = episodes
    want_losses, want_metrics, want_grads = jax_step
    step = teng.make_train_step(torch.optim.SGD(teng.cwt.parameters(), lr=0.0))
    metrics = step(batch, w0=torch.from_numpy(w0))
    assert not teng.cwt.training and not teng.backbone.training
    assert all(p.grad is None for p in teng.backbone.parameters())
    losses, _ = teng.train_episode_losses(batch, w0=torch.from_numpy(w0), with_metrics=False)
    np.testing.assert_allclose(losses.detach().numpy(), want_losses, rtol=1e-3)
    np.testing.assert_allclose(float(metrics["loss"]), want_losses.mean(), rtol=1e-3)
    for k in ("inter", "union", "inter0", "union0"):
        got = metrics[k].numpy()
        assert got.shape == want_metrics[k].shape == (E, 2), k
        # areas may differ by the few pixels whose argmax flips (< 0.5%)
        np.testing.assert_allclose(got, want_metrics[k], atol=0.005 * SIZE * SIZE, err_msg=k)
    grads = {k: p.grad for k, p in teng.cwt.named_parameters()}
    assert sorted(grads) == sorted(want_grads)
    top = max(float(w.abs().max()) for w in want_grads.values())
    for name, w in want_grads.items():
        w = w.numpy()
        if name == "layer_norm.bias":
            # shifts both class rows alike, so the K=2 loss (a function of
            # the row difference) has no gradient in it
            assert np.abs(w).max() == 0.0
            assert float(grads[name].abs().max()) <= 1e-6 * top
            continue
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(grads[name].numpy(), w, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(w).max()), err_msg=name)


def test_loss_only_step_returns_the_same_loss(pair, episodes):
    _, _, _, teng = pair
    batch, _, w0 = episodes
    full, _ = teng.train_episode_losses(batch, w0=torch.from_numpy(w0))
    fast, metrics = teng.train_episode_losses(batch, w0=torch.from_numpy(w0),
                                              with_metrics=False)
    assert metrics == {}
    torch.testing.assert_close(full, fast, rtol=0, atol=0)


def test_sgd_without_schedule_matches_optax():
    """The CWT trainer's optimizer: SGD, nesterov momentum, weight decay, and
    no schedule (``use_schedule=False``) whatever ``cfg.scheduler`` says."""
    cfg = default_cfg()
    assert cfg.scheduler == "cosine"
    cfg.epochs = 1
    rng = np.random.default_rng(6)
    p0 = rng.standard_normal(6).astype(np.float32)
    grads = rng.standard_normal((5, 6)).astype(np.float32)
    tx = jax_build_optimizer(cfg, base_lr=0.1, iters_per_epoch=2, use_schedule=False)
    p_jax = jnp.asarray(p0)
    state = tx.init(p_jax)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, sched = build_optimizer([param], cfg, base_lr=0.1, iters_per_epoch=2,
                                 use_schedule=False)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, p_jax)
        p_jax = optax.apply_updates(p_jax, upd)
        param.grad = torch.from_numpy(g.copy())
        opt.step()
        sched.step()
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(p_jax), rtol=1e-5,
                                   atol=1e-6)
    assert opt.param_groups[0]["lr"] == pytest.approx(0.1)


def _dropout_engine():
    cfg = _set_sizes(default_cfg(), 0.1)
    cfg.adapt_iter = 2
    return EpisodicEngine(cfg, device="cpu")


def test_train_steps_with_dropout_on_lower_the_loss():
    """Support dropout 0.1 and the CWT's 0.1 / 0.5 live: SGD steps on one
    batch lower its loss, measured with dropout off before and after."""
    engine = _dropout_engine()
    batch = make_episode_batch(21, 2, size=SIZE)
    w0 = engine.init_weights(2, torch.Generator().manual_seed(3))

    def clean_loss():
        rates = engine.cfg.dropout, engine.cwt.dropout, engine.cwt.attn_dropout
        engine.cfg.dropout = engine.cwt.dropout = engine.cwt.attn_dropout = 0.0
        try:
            with torch.no_grad():
                return float(engine.train_episode_losses(batch, w0=w0)[0].mean())
        finally:
            engine.cfg.dropout, engine.cwt.dropout, engine.cwt.attn_dropout = rates

    opt, _ = build_optimizer(engine.cwt.parameters(), engine.cfg, base_lr=0.02,
                             use_schedule=False)
    step = engine.make_train_step(opt, with_metrics=False)
    gen = torch.Generator().manual_seed(4)
    before = clean_loss()
    losses = [float(step(batch, gen, w0=w0)["loss"]) for _ in range(4)]
    after = clean_loss()
    assert np.all(np.isfinite(losses))
    assert after < before, (before, after, losses)


def test_same_generator_state_gives_the_same_step_bit_for_bit():
    engine = _dropout_engine()
    batch = make_episode_batch(22, 2, size=SIZE)
    start = {k: v.clone() for k, v in engine.cwt.state_dict().items()}
    results = []
    for seed in (5, 5, 6):
        engine.cwt.load_state_dict(start)
        opt, _ = build_optimizer(engine.cwt.parameters(), engine.cfg, base_lr=0.02,
                                 use_schedule=False)
        metrics = engine.make_train_step(opt)(batch, torch.Generator().manual_seed(seed))
        results.append((metrics, {k: v.clone() for k, v in engine.cwt.state_dict().items()}))
    (m_a, p_a), (m_b, p_b), (m_c, p_c) = results
    for k in m_a:
        assert torch.equal(m_a[k], m_b[k]), k
    assert all(torch.equal(p_a[k], p_b[k]) for k in p_a)
    assert not torch.equal(m_a["loss"], m_c["loss"])   # dropout and inits are live


# --------------------------------------------------------------------------- #
# trainer entry points
# --------------------------------------------------------------------------- #


def _train_cfg(model_dir, **opts):
    cfg = _set_sizes(default_cfg(), 0.1)
    cfg.adapt_iter = 2
    cfg.synthetic_data, cfg.epochs, cfg.iter_per_epoch, cfg.episode_batch = True, 2, 4, 2
    cfg.test_num, cfg.n_runs, cfg.save_models, cfg.model_dir = 2, 1, True, str(model_dir)
    for k, v in opts.items():
        cfg[k] = v
    return cfg


def _final(cfg):
    from few_shot_seg_cwt_tpu_torch.train.common import trans_ckpt_dir

    return load_ckpt(os.path.join(trans_ckpt_dir(cfg), "final.pth"))


def test_train_cwt_main_saves_resumes_and_hands_best_to_test(tmp_path):
    from few_shot_seg_cwt_tpu_torch.train import test as test_entry
    from few_shot_seg_cwt_tpu_torch.train import train_cwt
    from few_shot_seg_cwt_tpu_torch.train.common import trans_ckpt_dir

    quiet = lambda *_: None  # noqa: E731
    whole = _train_cfg(tmp_path / "whole")
    lines = []
    best = train_cwt.main(whole, device="cpu", log=lines.append)
    assert 0.0 < best <= 1.0
    out = Path(trans_ckpt_dir(whole))
    assert sorted(p.name for p in out.iterdir()) == ["best.pth", "final.pth", "log.txt",
                                                     "train_state.pth"]
    logged = (out / "log.txt").read_text().splitlines()
    assert logged == [str(line) for line in lines][len(lines) - len(logged):]
    assert any(line.startswith("mIoU---Val result: mIoU") for line in logged)
    assert is_full_train_state(str(out / "train_state.pth"))
    assert not is_full_train_state(str(out / "best.pth"))
    assert load_ckpt(str(out / "train_state.pth"))["meta"]["epoch"] == 2
    want = _final(whole)

    # stopped after one epoch, then resumed: by resume_ckpt, and by auto_resume
    for how in ("resume_ckpt", "auto_resume"):
        cut = _train_cfg(tmp_path / how, stop_after_epochs=1)
        train_cwt.main(cut, device="cpu", log=quiet)
        assert load_ckpt(os.path.join(trans_ckpt_dir(cut), "train_state.pth"))["meta"]["epoch"] == 1
        state = os.path.join(trans_ckpt_dir(cut), "train_state.pth")
        opts = {"resume_ckpt": state} if how == "resume_ckpt" else {"auto_resume": True}
        lines = []
        train_cwt.main(_train_cfg(tmp_path / how, **opts), device="cpu", log=lines.append)
        assert any("resumed full train state at epoch 1" in str(line) for line in lines)
        got = _final(_train_cfg(tmp_path / how))
        for k in want:
            assert torch.equal(got[k], want[k]), (how, k)

    # weights-only resume, and the test entry point evaluating best.pth
    lines = []
    train_cwt.main(_train_cfg(tmp_path / "w", epochs=1, resume_ckpt=str(out / "final.pth")),
                   device="cpu", log=lines.append)
    assert any("resumed transformer weights" in str(line) for line in lines)
    lines = []
    miou = test_entry.main(_train_cfg(tmp_path / "whole", ckpt_used="best"), device="cpu",
                           log=lines.append)
    assert any(f"loading transformer weight '{out / 'best.pth'}'" in str(line)
               for line in lines)
    assert miou == pytest.approx(best, abs=1e-7)


def test_train_head_main_resumes_to_the_uninterrupted_run(tmp_path, monkeypatch):
    from few_shot_seg_cwt_tpu_torch.train import train_head

    monkeypatch.chdir(tmp_path)
    config = str(Path(__file__).resolve().parents[1] / "configs" / "pascal_mmn.yaml")

    def cfg(exp, **opts):
        c = merge_cfg_from_list(load_cfg(config), [
            "image_size", str(SIZE), "adapt_iter", "2", "use_amp", "False",
            "synthetic_data", "True", "epochs", "2", "iter_per_epoch", "4",
            "episode_batch", "2", "test_num", "2", "save_models", "True",
            "exp_name", exp])
        for k, v in opts.items():
            c[k] = v
        return c

    def final(exp):
        return load_ckpt(str(next(tmp_path.rglob(f"{exp}/final.pt"))))

    quiet = lambda *_: None  # noqa: E731
    train_head.main(cfg("whole"), "mmn", device="cpu", log=quiet)
    state = next(tmp_path.rglob("whole/train_state.pt"))
    assert is_full_train_state(str(state))
    assert load_ckpt(str(state))["meta"]["epoch"] == 2
    want = final("whole")
    for how in ("resume_ckpt", "auto_resume"):
        train_head.main(cfg(how, stop_after_epochs=1), "mmn", device="cpu", log=quiet)
        cut = next(tmp_path.rglob(f"{how}/train_state.pt"))
        opts = {"resume_ckpt": str(cut)} if how == "resume_ckpt" else {"auto_resume": True}
        lines = []
        train_head.main(cfg(how, **opts), "mmn", device="cpu", log=lines.append)
        assert any("resumed full head train state after epoch 1" in str(line)
                   for line in lines)
        got = final(how)
        for k in want:
            assert torch.equal(got[k], want[k]), (how, k)
