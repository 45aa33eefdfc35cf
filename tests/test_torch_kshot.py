"""k-shot episodes: the port against the JAX package at shot 3 (CPU, 33 px
images -> 5x5 features, adapt_iter 5), and the k-shot trainer alias.

* (a) CWT ``eval_metrics_batch`` with one all-255 padded shot (the
  ``random_shot`` form): I/U equal, per-episode CE within 1e-4 relative.
* (b) MMN eval predictions (``wa True``, so the hoisted query prep does
  real work) for ``shot_hoist_query`` on and off, each with the per-shot
  map one shot a chunk, three a chunk (``shot_tile 3``) and every shot in
  one apply (``shot_native``): ``pred``/``pred1`` within 1e-4 of max|pred|
  of the JAX program with the same settings, and the six settings equal to
  each other within the JAX suite's own tolerance for its scanned and
  batched readouts (rtol 2e-4, atol 2e-5 of the scale;
  tests/test_shot_padding.py).
* (c) MMN train-step head gradients with ``shot_remat`` on and off (and
  ``loss_shot sum``): within 1e-3 of each tensor's max|g| of JAX's
  gradients, and equal to each other.

Weights: the JAX modules' variable trees drawn with numpy (BN fields
around identity, non-zero biases), carried to the port by
``utils/convert.py``; classifier inits: the JAX engine's draws, injected
into the port as ``w0``. Dropout is off where the two are compared. The
MMN config's ``wt_dc`` loss is swapped for ``wt_ce``: at 33 px with these
weights the dice loss saturates and every head gradient is exactly 0 in
both packages, which would hold nothing.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from few_shot_seg_cwt_tpu.config import default_cfg as jax_default_cfg
from few_shot_seg_cwt_tpu.config import load_cfg as jax_load_cfg
from few_shot_seg_cwt_tpu.config import merge_cfg_from_list as jax_merge
from few_shot_seg_cwt_tpu.episodic.engine import EpisodicEngine as JaxEngine
from few_shot_seg_cwt_tpu.episodic.heads import HeadEngine as JaxHeadEngine
from few_shot_seg_cwt_tpu.models.pspnet import init_classifier_weights as jax_init_w
from few_shot_seg_cwt_tpu_torch.config import default_cfg, load_cfg, merge_cfg_from_list
from few_shot_seg_cwt_tpu_torch.data.synthetic import make_episode_batch
from few_shot_seg_cwt_tpu_torch.episodic.engine import EpisodicEngine
from few_shot_seg_cwt_tpu_torch.episodic.heads import HeadEngine
from few_shot_seg_cwt_tpu_torch.models.cwt import build_cwt
from few_shot_seg_cwt_tpu_torch.models.mmn import build_mmn
from few_shot_seg_cwt_tpu_torch.models.pspnet import build_pspnet
from few_shot_seg_cwt_tpu_torch.utils.convert import (cwt_state_dict_from_flax,
                                                      mmn_state_dict_from_flax,
                                                      pspnet_state_dict_from_flax)

torch.set_num_threads(1)

CONFIG_MMN = str(Path(__file__).resolve().parents[1] / "configs" / "pascal_mmn.yaml")
SIZE, FEAT, SHOT, E = 33, 5, 3, 2
EP_KEYS = ("s_img", "s_label", "q_img", "q_label", "cls")
MMN_OPTS = ["image_size", str(SIZE), "adapt_iter", "5", "use_amp", "False",
            "att_drop", "0.0", "proj_drop", "0.0", "shot", str(SHOT), "loss_type", "wt_ce"]
# (shot_hoist_query, shot_tile, shot_native)
SHOT_SETTINGS = [(hoist, tile, native) for hoist in (True, False)
                 for tile, native in ((1, False), (3, False), (1, True))]


def seeded_variables(init, rng, he_kernels, *args):
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


def _episodes(seed):
    """E shot-3 episodes; episode 0's last shot is an all-255 pad, and one
    real support is partly 255."""
    batch = make_episode_batch(seed, E, size=SIZE, shot=SHOT)
    batch["s_label"][0, SHOT - 1] = 255
    batch["s_label"][1, 0, :4, :] = 255
    return {k: batch[k] for k in EP_KEYS}


# --------------------------------------------------------------------------- #
# (a) CWT engine at shot 3 with a padded shot
# --------------------------------------------------------------------------- #


def test_cwt_eval_metrics_with_a_padded_shot_match_jax():
    jcfg, tcfg = jax_default_cfg(), default_cfg()
    for cfg in (jcfg, tcfg):
        cfg.image_size, cfg.adapt_iter, cfg.shot = SIZE, 5, SHOT
    jeng = JaxEngine(jcfg)
    rng = np.random.default_rng(2021)
    vars_b = seeded_variables(
        lambda r, x: jeng.backbone.init({"params": r}, x, train=False), rng, True,
        jnp.zeros((1, SIZE, SIZE, 3)))
    f = jnp.zeros((1, FEAT, FEAT, 512))
    vars_t = seeded_variables(lambda r, w, q, k: jeng.cwt.init(r, w, q, k), rng, False,
                              jnp.zeros((1, 2, 512)), f, f)
    backbone = build_pspnet(tcfg)
    backbone.load_state_dict(pspnet_state_dict_from_flax(vars_b))
    cwt = build_cwt(tcfg)
    cwt.load_state_dict(cwt_state_dict_from_flax(vars_t))
    teng = EpisodicEngine(tcfg, backbone=backbone, cwt=cwt, device="cpu")

    batch = _episodes(8)
    rngs = jax.random.split(jax.random.PRNGKey(3), E)
    want = jeng.eval_metrics_batch(vars_b, vars_t, {k: jnp.asarray(v) for k, v in batch.items()},
                                   rngs)
    w0 = np.stack([np.array(jax_init_w(r, 2, 512)) for r in rngs])
    got = teng.eval_metrics_batch(batch, w0=torch.from_numpy(w0))
    for k in ("inter", "union", "inter0", "union0"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("loss", "loss0"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, err_msg=k)
    # the padded shot takes no part: dropping it gives the same episode 0
    two = {k: v[:1] for k, v in batch.items()}
    two["s_img"], two["s_label"] = two["s_img"][:, :SHOT - 1], two["s_label"][:, :SHOT - 1]
    alone = teng.eval_metrics_batch(two, w0=torch.from_numpy(w0[:1]))
    for k in ("inter", "union"):
        np.testing.assert_array_equal(alone[k].numpy()[0], got[k].numpy()[0], err_msg=k)


# --------------------------------------------------------------------------- #
# MMN at shot 3
# --------------------------------------------------------------------------- #


def _mmn_cfg(opts=()):
    return merge_cfg_from_list(load_cfg(CONFIG_MMN), MMN_OPTS + list(opts))


@pytest.fixture(scope="module")
def mmn_pair():
    """(JAX head engine, backbone vars, head params, port engine)."""
    jcfg = jax_merge(jax_load_cfg(CONFIG_MMN), MMN_OPTS)
    jeng = JaxHeadEngine(jcfg, "mmn")
    rng = np.random.default_rng(2021)
    vars_b = seeded_variables(
        lambda r, x: jeng.backbone.init({"params": r}, x, train=False), rng, True,
        jnp.zeros((1, SIZE, SIZE, 3)))
    feats = {3: [jnp.zeros((1, FEAT, FEAT, 1024))] * 6,
             4: [jnp.zeros((1, FEAT, FEAT, 2048))] * 3}
    f = jnp.zeros((1, FEAT, FEAT, 512))
    params = seeded_variables(jeng.head.init, rng, False, feats, feats, f, f)["params"]
    tcfg = _mmn_cfg()
    backbone = build_pspnet(tcfg)
    backbone.load_state_dict(pspnet_state_dict_from_flax(vars_b))
    head = build_mmn(tcfg)
    head.load_state_dict(mmn_state_dict_from_flax(params))
    teng = HeadEngine(tcfg, "mmn", backbone=backbone, head=head, device="cpu")
    return jeng, vars_b, params, teng


@pytest.fixture(scope="module")
def mmn_episodes(mmn_pair):
    """Episodes, their JAX keys and classifier inits, and the JAX prologue
    (backbone features + inner loop) of each episode, computed once."""
    jeng, vars_b, _, _ = mmn_pair
    batch = _episodes(3)
    rngs = jax.random.split(jax.random.PRNGKey(5), E)
    w0 = np.stack([np.array(jax_init_w(r, 2, 512)) for r in rngs])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    prologue = jax.jit(jeng.episode_parts)
    parts = [prologue(vars_b, {k: v[i] for k, v in jbatch.items()}, rngs[i]) for i in range(E)]
    return batch, rngs, w0, parts


def _set_shot_settings(cfg, hoist, tile, native):
    cfg.shot_hoist_query, cfg.shot_tile, cfg.shot_native = hoist, tile, native


@pytest.fixture(scope="module")
def port_preds(mmn_pair, mmn_episodes):
    """The port's deterministic predictions under each shot setting."""
    _, _, _, teng = mmn_pair
    batch, _, w0, _ = mmn_episodes
    out = {}
    for setting in SHOT_SETTINGS:
        _set_shot_settings(teng.cfg, *setting)
        out[setting] = teng.predict_batch(batch, w0=torch.from_numpy(w0))
    _set_shot_settings(teng.cfg, True, 1, False)
    return out


@pytest.mark.parametrize("setting", SHOT_SETTINGS,
                         ids=[f"hoist{int(h)}-tile{t}-native{int(n)}" for h, t, n in SHOT_SETTINGS])
def test_mmn_shot3_predictions_match_jax(mmn_pair, mmn_episodes, port_preds, setting):
    """(b): each shot setting against the JAX head tail with the same
    setting (on the same JAX prologue), and against the default setting."""
    jeng, _, params, _ = mmn_pair
    batch, rngs, _, parts = mmn_episodes
    _set_shot_settings(jeng.cfg, *setting)
    try:
        tail = jax.jit(lambda p, ep, r: jeng._loss_mmn({"params": params}, p, ep, r,
                                                       det=True)[1])
        want = [tail(parts[i], {k: jnp.asarray(v[i]) for k, v in batch.items()}, rngs[i])
                for i in range(E)]
    finally:
        _set_shot_settings(jeng.cfg, True, 1, False)
    got, base = port_preds[setting], port_preds[(True, 1, False)]
    for i in range(E):
        for key in ("pred", "pred1"):
            g, w = got[key][i].numpy(), np.asarray(want[i][key])
            assert g.shape == w.shape == (SIZE, SIZE, 2)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * float(np.abs(w).max()),
                                       err_msg=f"{setting} {key} episode {i}")
            b = base[key][i].numpy()
            np.testing.assert_allclose(g, b, rtol=2e-4, atol=2e-5 * float(np.abs(b).max()),
                                       err_msg=f"{setting} vs default, {key} episode {i}")


@pytest.fixture(scope="module")
def jax_grads(mmn_pair, mmn_episodes):
    """jax.grad of the JAX train_episode_loss for episode 0 (the one with
    the padded shot), dropout off, loss_shot avg and sum."""
    jeng, vars_b, params, _ = mmn_pair
    batch, rngs, _, _ = mmn_episodes
    ep = {k: jnp.asarray(v[0]) for k, v in batch.items()}
    out = {}
    for loss_shot in ("avg", "sum"):
        jeng.cfg.loss_shot = loss_shot
        try:
            grads = jax.jit(jax.grad(
                lambda p: jeng.train_episode_loss(p, vars_b, ep, rngs[0])[0]))(params)
        finally:
            jeng.cfg.loss_shot = "avg"
        out[loss_shot] = mmn_state_dict_from_flax(jax.tree.map(np.asarray, grads))
    # the engine splits the key: the first half draws the classifier init
    w0 = np.array(jax_init_w(jax.random.split(rngs[0])[0], 2, 512))
    return out, w0


@pytest.mark.parametrize("loss_shot", ["avg", "sum"])
def test_mmn_shot3_train_gradients_match_jax(mmn_pair, mmn_episodes, jax_grads, loss_shot):
    """(c): the per-shot checkpoint changes no gradient."""
    _, _, _, teng = mmn_pair
    batch, _, _, _ = mmn_episodes
    want_all, w0 = jax_grads
    want = want_all[loss_shot]
    one = {k: v[:1] for k, v in batch.items()}
    grads = {}
    teng.cfg.loss_shot = loss_shot
    try:
        for remat in (True, False):
            teng.cfg.shot_remat = remat
            metrics = teng.backward_batch(one, w0=torch.from_numpy(w0[None]), deterministic=True)
            assert torch.isfinite(metrics["loss_mean"])
            grads[remat] = {k: p.grad.clone() for k, p in teng.head.named_parameters()}
    finally:
        teng.cfg.loss_shot, teng.cfg.shot_remat = "avg", True
    assert sorted(grads[True]) == sorted(want)
    for name, w in want.items():
        w = w.numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, name
        for remat in (True, False):
            np.testing.assert_allclose(grads[remat][name].numpy(), w, rtol=0, atol=1e-3 * scale,
                                       err_msg=f"{name} shot_remat {remat}")
        torch.testing.assert_close(grads[True][name], grads[False][name], rtol=1e-5,
                                   atol=1e-6 * scale)
    if loss_shot == "sum":
        assert not np.allclose(want["corr_net.NeighConsensus.conv.0.conv1.weight"].numpy(),
                               want_all["avg"]["corr_net.NeighConsensus.conv.0.conv1.weight"]
                               .numpy())


def test_mmn_shot5_train_step_with_dropout_replays_each_shots_draws(mmn_pair):
    """A 5-shot train step with dropout on (the pair's weights): the
    per-shot checkpoint's recompute replays each chunk's draws from the
    default generator, so ``shot_remat`` on and off give the same gradients
    from the same generator state, hoisted query prep or not."""
    _, _, _, teng = mmn_pair
    cfg = _mmn_cfg(["att_drop", "0.5", "proj_drop", "0.5", "adapt_iter", "2", "shot", "5"])
    head = build_mmn(cfg)
    head.load_state_dict(teng.head.state_dict())
    engine = HeadEngine(cfg, "mmn", backbone=teng.backbone, head=head, device="cpu")
    batch = make_episode_batch(4, 1, size=SIZE, shot=5)
    for hoist in (True, False):
        grads = {}
        for remat in (True, False):
            cfg.shot_hoist_query, cfg.shot_remat = hoist, remat
            torch.manual_seed(11)
            m = engine.backward_batch(batch, torch.Generator().manual_seed(1))
            assert torch.isfinite(m["loss_mean"])
            grads[remat] = {k: p.grad.clone() for k, p in engine.head.named_parameters()}
        assert any(float(g.abs().max()) > 0 for g in grads[True].values())
        for k in grads[True]:
            torch.testing.assert_close(grads[True][k], grads[False][k], rtol=1e-5,
                                       atol=1e-6 * float(grads[False][k].abs().max()),
                                       msg=f"{k}, shot_hoist_query {hoist}")


# --------------------------------------------------------------------------- #
# the trainer alias and the entry points at shot 5
# --------------------------------------------------------------------------- #


def test_train_kshot_main_runs_mmn_at_shot5(tmp_path, monkeypatch):
    from few_shot_seg_cwt_tpu_torch.train import train_kshot

    monkeypatch.chdir(tmp_path)
    cfg = _mmn_cfg(["adapt_iter", "2", "synthetic_data", "True", "epochs", "1",
                    "iter_per_epoch", "2", "episode_batch", "1", "test_num", "2",
                    "shot", "5"])
    lines = []
    best = train_kshot.main(cfg, device="cpu", log=lines.append)
    assert 0.0 <= best <= 1.0
    assert any(str(line).startswith("val: mIoU") for line in lines)


def test_cwt_entry_points_run_at_shot5(tmp_path, monkeypatch):
    from few_shot_seg_cwt_tpu_torch.train import test as test_entry
    from few_shot_seg_cwt_tpu_torch.train import train_cwt

    monkeypatch.chdir(tmp_path)
    cfg = default_cfg()
    cfg.image_size, cfg.adapt_iter, cfg.shot = SIZE, 2, 5
    cfg.synthetic_data, cfg.test_num, cfg.n_runs, cfg.episode_batch = True, 2, 1, 2
    cfg.epochs, cfg.iter_per_epoch, cfg.model_dir = 1, 2, str(tmp_path / "model")
    lines = []
    assert 0.0 <= test_entry.main(cfg, device="cpu", log=lines.append) <= 1.0
    assert np.isfinite(train_cwt.main(cfg, device="cpu", log=lines.append))
