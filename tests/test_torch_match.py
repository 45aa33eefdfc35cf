"""The port's MatchNet family against the JAX package, on the CPU: the 6D
``NeighConsensus`` (centre-pivot and true 4D), ``MatchNet`` on the rank-4,
flat and 6D routes with ``sce``, ``cyc`` and an ignore mask, the ``rmid nr``
tap, the match ``HeadEngine`` (eval with and without ``ignore``, serve and
the train step's gradients) on ``configs/pascal_match.yaml`` at 33 px and
adapt_iter 5, the ``meta_aug`` support stream, ``eval_episode_tile``,
``train_match.main`` with its resume, and the ``utils/convert.py`` <->
``import_matchnet`` / ``import_mmn`` round trips.

Weights: the JAX modules' trees filled from a numpy seed (non-zero biases),
carried to the port by ``utils/convert.py``. The engine comparisons run
the JAX prologue once per episode (``episode_parts``, jitted) and its
``_loss_match`` eagerly on those parts for each setting; the port gets the
JAX classifier-init draw of each episode as ``w0``. The flat route runs
the pivot pair's plain version on CPU tensors. Tolerances: rtol 1e-5 for
the consensus, rtol 1e-4 (atol 1e-4 of the scale) for MatchNet, rtol 1e-2
(atol 2e-3 of the logit scale) and argmax agreement >= 99.5% for the
engine's predictions, gradients rtol 1e-3 (atol 1e-3 of each tensor's
largest entry).
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
from few_shot_seg_cwt_tpu.models.matching import MatchNet as JaxMatchNet
from few_shot_seg_cwt_tpu.models.matching import NeighConsensus as JaxNeighConsensus
from few_shot_seg_cwt_tpu.models.mmn import MMN as JaxMMN
from few_shot_seg_cwt_tpu.models.pspnet import init_classifier_weights as jax_init_w
from few_shot_seg_cwt_tpu.ops.losses import cross_entropy as jax_ce
from few_shot_seg_cwt_tpu.utils.ckpt import import_matchnet, import_mmn
from few_shot_seg_cwt_tpu_torch.config import load_cfg, merge_cfg_from_list
from few_shot_seg_cwt_tpu_torch.data.synthetic import make_episode_batch
from few_shot_seg_cwt_tpu_torch.episodic.heads import HeadEngine, build_match
from few_shot_seg_cwt_tpu_torch.models.matching import MatchNet, NeighConsensus
from few_shot_seg_cwt_tpu_torch.models.mmn import MMN
from few_shot_seg_cwt_tpu_torch.models.pspnet import build_pspnet
from few_shot_seg_cwt_tpu_torch.ops import cuda_pivot
from few_shot_seg_cwt_tpu_torch.utils.convert import (matchnet_state_dict_from_flax,
                                                      mmn_state_dict_from_flax,
                                                      pspnet_state_dict_from_flax)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MATCH_CONFIG = str(ROOT / "configs" / "pascal_match.yaml")
MMN_CONFIG = str(ROOT / "configs" / "pascal_mmn.yaml")
SIZE, FEAT, E = 33, 5, 2
OPTS = ["image_size", str(SIZE), "adapt_iter", "5"]
EP_KEYS = ("s_img", "s_label", "q_img", "q_label", "cls")
SWITCHES = ("FSS_PIVOT_MXU", "FSS_PIVOT_PALLAS", "FSS_DISABLE_PALLAS", "FSS_NCONS_R4",
            "FSS_CONV4D_IM2COL")
H = W = 5
C = 16


@pytest.fixture
def route(request, monkeypatch):
    """"flat": the pivot-kernel route (FSS_PIVOT_MXU=1); "6d": the 6D route
    (FSS_NCONS_R4=0); "r4": the rank-4 default."""
    for var in SWITCHES:
        monkeypatch.delenv(var, raising=False)
    if request.param == "flat":
        monkeypatch.setenv("FSS_PIVOT_MXU", "1")
    elif request.param == "6d":
        monkeypatch.setenv("FSS_NCONS_R4", "0")
    return request.param


def _noisy(tree, rng, scale=0.1):
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        + rng.normal(0, scale, np.shape(a)).astype(np.float32), tree)


def _close(got, want, rtol, atol_frac):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_frac * float(np.abs(want).max()))


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)]


# --------------------------------------------------------------------------- #
# NeighConsensus on the 6D route
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module", params=["red", "cv4"])
def consensus6(request):
    """JAX NeighConsensus (1->10->10->1, symmetric) on a 6D volume with noisy
    params, its output, and the port's consensus on the same weights."""
    conv = request.param
    rng = np.random.default_rng(41)
    x6 = rng.standard_normal((2, 4, 5, 3, 6, 1)).astype(np.float32)
    mod = JaxNeighConsensus(conv=conv, block_remat=False)
    params = _noisy(mod.init(jax.random.PRNGKey(0), jnp.asarray(x6))["params"], rng)
    want = np.asarray(mod.apply({"params": jax.tree.map(jnp.asarray, params)},
                                jnp.asarray(x6)))
    sd = matchnet_state_dict_from_flax({"ncons": params})
    port = NeighConsensus(conv=conv, block_remat=False)
    port.load_state_dict({k[len("NeighConsensus."):]: v for k, v in sd.items()})
    return conv, x6, want, port


def test_neigh_consensus_6d_matches_jax(consensus6):
    """stack(x) + swap(stack(swap(x))) on the 6D route, both conv kinds."""
    _, x6, want, port = consensus6
    with torch.no_grad():
        got = port(torch.from_numpy(x6))
    _close(got.numpy(), want, 1e-5, 1e-5)


def test_neigh_consensus_6d_grads_do_not_depend_on_remat(consensus6):
    _, x6, _, port = consensus6
    grads = []
    for remat in (False, True):
        port.block_remat = remat
        port.zero_grad()
        port(torch.from_numpy(x6)).square().sum().backward()
        grads.append([p.grad.clone() for p in port.parameters()])
    port.block_remat = False
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------- #
# MatchNet on every route
# --------------------------------------------------------------------------- #

MATCH_CASES = {
    "plain": dict(sce=False, cyc=False, cv_type="red"),
    "sce_cyc_ignore": dict(sce=True, cyc=True, cv_type="red"),
    "cv4_cyc": dict(sce=False, cyc=True, cv_type="cv4"),
}


@pytest.fixture(scope="module", params=sorted(MATCH_CASES))
def matchnet_pair(request):
    """(case, inputs, JAX (readout, corr), noisy params, port MatchNet). The
    JAX side runs its default route at eval (use_cyc on, deterministic)."""
    case = request.param
    opts = MATCH_CASES[case]
    rng = np.random.default_rng(42)
    fq, fs = (rng.standard_normal((2, H, W, C)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((2, H, W, 8)).astype(np.float32)
    s_mask = rng.integers(0, 2, (2, H, W)).astype(np.int32)
    ig = rng.random((2, H * W)) < 0.2 if case == "sce_cyc_ignore" else None
    jmod = JaxMatchNet(temp=20.0, block_remat=False, **opts)
    jin = [jnp.asarray(a) for a in (fq, fs, v)]
    params = _noisy(jmod.init(jax.random.PRNGKey(1), *jin)["params"], rng)
    kw = dict(s_mask=jnp.asarray(s_mask), use_cyc=opts["cyc"], deterministic=True,
              ret_corr=True, ig_mask=None if ig is None else jnp.asarray(ig))
    want = jmod.apply({"params": jax.tree.map(jnp.asarray, params)}, *jin, **kw)
    port = MatchNet(temp=20.0, block_remat=False, feat_dim=C, **opts)
    port.load_state_dict(matchnet_state_dict_from_flax(params))
    return case, (fq, fs, v, s_mask, ig), [np.asarray(w) for w in want], params, port


@pytest.mark.parametrize("route", ["r4", "flat", "6d"], indirect=True)
def test_matchnet_matches_jax(matchnet_pair, route):
    case, (fq, fs, v, s_mask, ig), want, _, port = matchnet_pair
    before = dict(cuda_pivot.LAUNCHES)
    with torch.no_grad():
        got = port(torch.from_numpy(fq), torch.from_numpy(fs), torch.from_numpy(v),
                   s_mask=torch.from_numpy(s_mask).long(),
                   ig_mask=None if ig is None else torch.from_numpy(ig),
                   use_cyc=MATCH_CASES[case]["cyc"], deterministic=True, ret_corr=True)
    assert cuda_pivot.LAUNCHES == before
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g.numpy(), w, 1e-4, 1e-4)


def test_cyc_dropout_draws_from_the_generator():
    """use_cyc outside deterministic mode: the cycle mask goes through
    dropout (rate 0.1) drawn from the given generator."""
    port = MatchNet(cyc=True)
    gen = torch.Generator().manual_seed(0)
    corr = torch.rand(2, H * W, H * W, generator=gen)
    sm = torch.randint(0, 2, (2, H, W), generator=gen)
    det = port.run_cyc(corr, sm, True)
    a = port.run_cyc(corr, sm, False, torch.Generator().manual_seed(7))
    b = port.run_cyc(corr, sm, False, torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
    assert set(torch.unique(det).tolist()) <= {0.0, 1.0}
    kept = a[det > 0]
    assert set(torch.unique(kept).tolist()) <= {0.0, float(torch.tensor(1.0) / 0.9)}
    assert torch.equal(a[det == 0], torch.zeros_like(a[det == 0]))


def test_import_matchnet_round_trip(matchnet_pair):
    """import_matchnet(port.state_dict()) gives back the flax tree leaf for
    leaf, both conv kinds and the SCE conv."""
    case, _, _, params, port = matchnet_pair
    back = import_matchnet(port.state_dict())["params"]
    got, want = _leaves(back), _leaves(params)
    assert [p for p, _ in got] == [p for p, _ in want], case
    for (_, g), (path, w) in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=path)


def test_import_mmn_round_trip_with_the_true_4d_consensus():
    rng = np.random.default_rng(43)
    feats = {3: [jnp.zeros((1, H, W, 12))], 4: [jnp.zeros((1, H, W, 24))]}
    f = jnp.zeros((1, H, W, 32))
    jmod = JaxMMN(bids=(3, 4), all_lr="l", wa=True, cv_type="cv4", block_remat=False,
                  feature_channels=(8, 8, 12, 24))
    params = _seeded_variables(jmod.init, rng, False, feats, feats, f, f)["params"]
    port = MMN(bids=(3, 4), all_lr="l", wa=True, cv_type="cv4", block_remat=False,
               feature_channels=(8, 8, 12, 24))
    port.load_state_dict(mmn_state_dict_from_flax(params))
    back = import_mmn(port.state_dict())["params"]
    got, want = _leaves(back), _leaves(params)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, g), (path, w) in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=path)


# --------------------------------------------------------------------------- #
# the match head engine
# --------------------------------------------------------------------------- #


def _cfg(path=MATCH_CONFIG, opts=()):
    return merge_cfg_from_list(load_cfg(path), OPTS + list(opts))


def _seeded_variables(init, rng, he_kernels, *args):
    """A flax module's variables drawn with numpy (``jax.eval_shape`` gives
    the tree without compiling the init): conv kernels He-normal over
    fan-out (the backbone's) or U(+-1/sqrt(fan_in)) (the head's), BN
    scale/var in [0.5, 1.5), biases, BN means and the classifier N(0, 0.05),
    the gamma scalar 0.2."""
    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel" and he_kernels:
            return rng.normal(0, np.sqrt(2 / (shape[0] * shape[1] * shape[-1])), shape)
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
def match_pair():
    """(JAX engine, its backbone vars, head params, port engine, episodes,
    per-episode JAX parts and w0). One support label partly 255."""
    jcfg = jax_merge(jax_load_cfg(MATCH_CONFIG), OPTS)
    jeng = JaxHeadEngine(jcfg, "match")
    rng = np.random.default_rng(2022)
    vars_b = _seeded_variables(
        lambda r, x: jeng.backbone.init({"params": r}, x, train=False), rng, True,
        jnp.zeros((1, SIZE, SIZE, 3)))
    f = jnp.zeros((1, FEAT, FEAT, 2048))
    params = _seeded_variables(jeng.head.init, rng, False, f, f, jnp.zeros((1, FEAT, FEAT, 512)))
    params = params["params"]

    tcfg = _cfg()
    backbone = build_pspnet(tcfg)
    backbone.load_state_dict(pspnet_state_dict_from_flax(vars_b, dist=tcfg.dist))
    head = build_match(tcfg)
    head.load_state_dict(matchnet_state_dict_from_flax(params))
    teng = HeadEngine(tcfg, "match", backbone=backbone, head=head, device="cpu")

    batch = make_episode_batch(6, E, size=SIZE)
    batch["s_label"][0, 0, :4, :] = 255
    batch = {k: batch[k] for k in EP_KEYS}
    rngs = jax.random.split(jax.random.PRNGKey(8), E)
    w0 = np.stack([np.array(jax_init_w(r, 2, 512)) for r in rngs])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    parts_fn = jax.jit(lambda ep, r: jeng.episode_parts(vars_b, ep, r))
    eps = [{k: v[i] for k, v in jbatch.items()} for i in range(E)]
    parts = [parts_fn(eps[i], rngs[i]) for i in range(E)]
    return jeng, params, teng, batch, eps, parts, w0, rngs


def _jax_preds(match_pair, ignore=False):
    jeng, params, _, _, eps, parts, _, rngs = match_pair
    jeng.cfg.ignore = ignore
    try:
        return [{k: np.asarray(v) for k, v in jeng._loss_match(
            {"params": params}, parts[i], eps[i], rngs[i], det=True)[1].items()}
            for i in range(E)]
    finally:
        jeng.cfg.ignore = False


def test_rmid_nr_tap_matches_jax(match_pair):
    """``rmid nr``: feats["nr"] is layer4's last block before its ReLU (its
    ReLU is feats[4][-1]); ``mid4`` reads feats[4][-1] of the same trunk."""
    jeng, _, teng, batch, _, _, _, _ = match_pair
    from few_shot_seg_cwt_tpu.models.pspnet import build_pspnet as jax_build_pspnet
    jcfg = jax_merge(jeng.cfg.clone(), ["rmid", "nr"])
    jback = jax_build_pspnet(jcfg)
    x = batch["q_img"]
    vars_b = _seeded_variables(lambda r, i: jback.init({"params": r}, i, train=False),
                               np.random.default_rng(7), True, jnp.zeros((1, SIZE, SIZE, 3)))
    ref_nr, ref_4 = jax.jit(lambda v, i: (lambda f: (f["nr"][0], f[4][-1]))(jback.apply(
        v, i, train=False, method=jback.extract_features)[1]))(vars_b, x)
    port = build_pspnet(_cfg(opts=["rmid", "nr"]))
    port.load_state_dict(pspnet_state_dict_from_flax(vars_b, dist="cosN"))
    with torch.no_grad():
        _, feats = port.eval().extract_features(torch.from_numpy(x))
    nr = feats["nr"][0].numpy()
    _close(nr, ref_nr, 1e-3, 1e-4)
    _close(feats[4][-1].numpy(), ref_4, 1e-3, 1e-4)
    assert (nr < 0).any()
    np.testing.assert_array_equal(np.maximum(nr, 0), feats[4][-1].numpy())


@pytest.mark.parametrize("route", ["r4", "flat", "6d"], indirect=True)
def test_match_eval_matches_jax(match_pair, route):
    """eval_metrics_batch and predict_batch (cycle mask on) against the JAX
    ``_loss_match`` at eval on the same parts."""
    _, _, teng, batch, eps, _, w0, _ = match_pair
    want = _jax_preds(match_pair)
    got = teng.predict_batch(batch, w0=torch.from_numpy(w0))
    metrics = teng.eval_metrics_batch(batch, w0=torch.from_numpy(w0))
    for i in range(E):
        for key in ("pred1", "pred"):
            g, w = got[key][i].numpy(), want[i][key]
            assert g.shape == w.shape == (SIZE, SIZE, 2)
            _close(g, w, 1e-2, 2e-3)
            assert (g.argmax(-1) == w.argmax(-1)).mean() >= 0.995, (i, key)
        ce = float(jax_ce(jnp.asarray(want[i]["pred"]), eps[i]["q_label"]))
        np.testing.assert_allclose(float(metrics["loss"][i]), ce, rtol=1e-2)


def test_match_ignore_eval_matches_jax(match_pair, monkeypatch):
    """``ignore True``: the eval readout redone over the query feature with
    the support ignore mask; serving refuses it, as in JAX."""
    _, _, teng, batch, _, _, w0, _ = match_pair
    want = _jax_preds(match_pair, ignore=True)
    plain = _jax_preds(match_pair)
    assert not np.allclose(want[0]["pred1"], plain[0]["pred1"])
    monkeypatch.setitem(teng.cfg, "ignore", True)
    parts = teng.episode_parts(teng.to_device(batch), torch.from_numpy(w0))
    for i in range(E):
        part, episode = teng._one(parts, teng.to_device(batch), i)
        with torch.no_grad():
            _, preds = teng._loss_match(part, episode, det=True)
        for key in ("pred1", "pred"):
            _close(preds[key].numpy(), want[i][key], 1e-2, 2e-3)
    with pytest.raises(ValueError, match="ignore False"):
        teng.serve_batch(batch, w0=torch.from_numpy(w0))


def test_match_serve_matches_eval(match_pair):
    _, _, teng, batch, _, _, w0, _ = match_pair
    want = _jax_preds(match_pair)
    masks = teng.serve_batch(batch, w0=torch.from_numpy(w0))
    assert masks.shape == (E, SIZE, SIZE) and masks.dtype == torch.int32
    one = teng.serve_episode({k: v[1] for k, v in batch.items()}, w0=w0[1])
    assert torch.equal(one, masks[1])
    for i in range(E):
        assert (masks[i].numpy() == want[i]["pred"].argmax(-1)).mean() >= 0.995


@pytest.fixture(scope="module")
def match_grads(match_pair):
    """jax.grad of the JAX train loss for episode 0 (cycle mask off in
    training, as in both packages), as a port state_dict."""
    jeng, params, _, _, eps, parts, _, rngs = match_pair
    grads = jax.grad(lambda p: jeng._loss_match({"params": p}, parts[0], eps[0], rngs[0],
                                                det=False)[0])(jax.tree.map(jnp.asarray, params))
    return matchnet_state_dict_from_flax(jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("route", ["r4", "flat", "6d"], indirect=True)
def test_match_train_step_gradient_matches_jax(match_pair, match_grads, route):
    """Episode 0's head gradients against jax.grad of the JAX train loss."""
    _, _, teng, batch, _, _, w0, _ = match_pair
    want = match_grads
    one = {k: v[:1] for k, v in batch.items()}
    metrics = teng.backward_batch(one, w0=torch.from_numpy(w0[:1]), deterministic=True)
    assert torch.isfinite(metrics["loss_mean"])
    got = {k: p.grad for k, p in teng.head.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = w.numpy()
        assert np.abs(w).max() > 0, name
        _close(got[name].numpy(), w, 1e-3, 1e-3)


# --------------------------------------------------------------------------- #
# the meta_aug support stream and eval_episode_tile
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("att_type", [0, 1, 3])
def test_select_support_stream_matches_jax(att_type):
    """meta_aug 2: the views the head reads, from interleaved [org, aug]
    pairs; att_type 3 picks per pair the view the adapted classifier
    segments better."""
    rng = np.random.default_rng(44)
    n = 4
    s_label = rng.integers(0, 2, (n, 9, 9)).astype(np.int32)
    s_label[1, :2] = 255
    parts = {"f_s": rng.standard_normal((n, 3, 3, 4)).astype(np.float32),
             "fs_feats": {4: [rng.standard_normal((n, 3, 3, 6)).astype(np.float32)]},
             "pd_s": rng.standard_normal((n, 3, 3, 2)).astype(np.float32),
             "s_valid": np.ones(n, np.float32)}
    opts = ["meta_aug", "2", "att_type", str(att_type)]
    jeng = JaxHeadEngine(jax_merge(jax_load_cfg(MMN_CONFIG), OPTS + opts), "mmn")
    want = jeng._select_support_stream(jax.tree.map(jnp.asarray, parts),
                                       {"s_label": jnp.asarray(s_label)})
    teng = HeadEngine.__new__(HeadEngine)
    teng.cfg, teng.num_classes = _cfg(MMN_CONFIG, opts), 2
    got = teng._select_support_stream(jax.tree.map(torch.from_numpy, parts),
                                      {"s_label": torch.from_numpy(s_label)})
    assert got["f_s"].shape[0] == 2
    for (_, g), (path, w) in zip(_leaves(jax.tree.map(np.asarray, got)), _leaves(want)):
        np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.fixture(scope="module")
def mmn_engine():
    # wt_ce: the config's wt_dc gives exactly 0 head gradients at 33 px
    cfg = _cfg(MMN_CONFIG, ["use_amp", "False", "att_drop", "0.0", "proj_drop", "0.0",
                            "loss_type", "wt_ce"])
    engine = HeadEngine(cfg, "mmn", device="cpu")
    with torch.no_grad():   # positive biases: a zero-bias random consensus may be dead
        for blk in list(engine.head.corr_net.NeighConsensus.conv)[::2]:
            blk.conv1.bias.fill_(0.1)
    return engine


@pytest.mark.parametrize("att_type", [0, 1, 3])
def test_meta_aug_runs_the_selected_views(mmn_engine, att_type, monkeypatch):
    """meta_aug 2: the head's prediction is that of a 1-shot episode holding
    only the selected view (the inner loop adapts on both views), and a
    train step runs and reaches the consensus."""
    batch = make_episode_batch(9, E, size=SIZE, shot=2)
    batch = {k: batch[k] for k in EP_KEYS}
    w0 = mmn_engine.init_weights(E, torch.Generator().manual_seed(1))
    monkeypatch.setitem(mmn_engine.cfg, "meta_aug", 2)
    monkeypatch.setitem(mmn_engine.cfg, "att_type", att_type)
    got = mmn_engine.predict_batch(batch, w0=w0)
    tb = mmn_engine.to_device(batch)
    parts = mmn_engine.episode_parts(tb, w0)
    for i in range(E):
        part, episode = mmn_engine._one(parts, tb, i)
        sel = mmn_engine._select_support_stream(part, episode)
        assert sel["f_s"].shape[0] == 1
        if att_type in (0, 1):
            assert torch.equal(sel["f_s"], part["f_s"][att_type:att_type + 1])
        monkeypatch.setitem(mmn_engine.cfg, "meta_aug", 1)
        with torch.no_grad():
            _, ref = mmn_engine._loss_mmn(sel, episode, det=True)
        monkeypatch.setitem(mmn_engine.cfg, "meta_aug", 2)
        torch.testing.assert_close(got["pred"][i], ref["pred"], rtol=1e-5, atol=1e-6)
    if att_type == 3:
        metrics = mmn_engine.backward_batch(batch, w0=w0, deterministic=True)
        assert torch.isfinite(metrics["loss_mean"])
        grads = {k: p.grad for k, p in mmn_engine.head.named_parameters()}
        assert all(g is not None and torch.isfinite(g).all() for g in grads.values())
        assert float(grads["corr_net.NeighConsensus.conv.4.conv1.bias"].abs().max()) > 0


@pytest.mark.parametrize("head", ["mmn", "match"])
def test_eval_episode_tile_equals_untiled(mmn_engine, match_pair, head, monkeypatch):
    """eval_episode_tile 2 runs the head on chunks of two episodes in one
    batched call; 3 does not divide 4, so it runs one at a time. Both give
    the untiled predictions."""
    engine = mmn_engine if head == "mmn" else match_pair[2]
    batch = make_episode_batch(10, 4, size=SIZE)
    batch = {k: batch[k] for k in EP_KEYS}
    w0 = engine.init_weights(4, torch.Generator().manual_seed(2))
    base = engine.predict_batch(batch, w0=w0)
    calls = []
    monkeypatch.setattr(engine, "_head_chunk",
                        lambda pieces, f=engine._head_chunk: calls.append(len(pieces))
                        or f(pieces))
    for tile, chunks in ((2, [2, 2]), (3, [])):
        calls.clear()
        monkeypatch.setitem(engine.cfg, "eval_episode_tile", tile)
        got = engine.predict_batch(batch, w0=w0)
        assert calls == chunks
        for k in ("pred1", "pred"):
            torch.testing.assert_close(got[k], base[k], rtol=1e-5, atol=1e-5)
            assert torch.equal(got[k].argmax(-1), base[k].argmax(-1))


# --------------------------------------------------------------------------- #
# the trainer entry point and what stays unported
# --------------------------------------------------------------------------- #


def test_train_match_main_and_resume(tmp_path, monkeypatch):
    """Two epochs in one run, and one epoch then a resume from its train
    state, end on the same head weights."""
    from few_shot_seg_cwt_tpu_torch.train import train_match

    monkeypatch.chdir(tmp_path)
    opts = ["adapt_iter", "2", "synthetic_data", "True", "epochs", "2", "iter_per_epoch",
            "2", "episode_batch", "2", "test_num", "2", "save_models", "True"]
    finals = []
    for name, extra in (("full", []), ("split", ["stop_after_epochs", "1"])):
        lines = []
        best = train_match.main(_cfg(opts=opts + ["exp_name", name] + extra), device="cpu",
                                log=lines.append)
        assert 0.0 <= best <= 1.0
        assert any(str(line).startswith("val: mIoU") for line in lines)
        finals.append(next(tmp_path.rglob(f"{name}/final.pt")))
    state = next(tmp_path.rglob("split/train_state.pt"))
    lines = []
    train_match.main(_cfg(opts=opts + ["exp_name", "split", "resume_ckpt", str(state)]),
                     device="cpu", log=lines.append)
    assert any("resumed full head train state after epoch 1" in str(l) for l in lines)
    full, resumed = (torch.load(p, weights_only=True) for p in finals)
    assert sorted(full) == sorted(resumed)
    for k in full:
        torch.testing.assert_close(resumed[k], full[k], rtol=0, atol=0, msg=k)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        train_match.main(_cfg(opts=["crm_type", "chm"]), device="cpu")


def test_disagreement_loss_matches_jax():
    """The ``aux`` loss: CE weighted 1 where pred0 and pred1 disagree, 0.001
    elsewhere, ignored pixels out."""
    from few_shot_seg_cwt_tpu.episodic.heads import _disagreement_loss
    from few_shot_seg_cwt_tpu_torch.episodic.heads import disagreement_loss

    rng = np.random.default_rng(45)
    pred, pred0, pred1 = (rng.standard_normal((9, 7, 2)).astype(np.float32) for _ in range(3))
    label = rng.integers(0, 2, (9, 7)).astype(np.int32)
    label[:2] = 255
    want = _disagreement_loss(*(jnp.asarray(a) for a in (pred, pred0, pred1, label)))
    got = disagreement_loss(*(torch.from_numpy(a) for a in (pred, pred0, pred1)),
                            torch.from_numpy(label).long())
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_train_aug_and_ddp_aliases(tmp_path, monkeypatch):
    """train_aug is the MMN trainer; train_ddp, the MMN trainer over the
    processes torchrun starts (tests/test_torch_parallel_trainers.py runs
    it at WORLD_SIZE 2), refuses a WORLD_SIZE that no launcher set up and a
    ``distributed`` config without WORLD_SIZE, rather than train on one
    process."""
    from few_shot_seg_cwt_tpu_torch.train import train_aug, train_ddp

    monkeypatch.chdir(tmp_path)
    cfg = _cfg(MMN_CONFIG, ["adapt_iter", "2", "synthetic_data", "True", "epochs", "1",
                            "iter_per_epoch", "2", "episode_batch", "2", "test_num", "2",
                            "use_amp", "False", "save_models", "False"])
    lines = []
    assert 0.0 <= train_aug.main(cfg, device="cpu", log=lines.append) <= 1.0
    assert any(str(line).startswith("==> Start training head 'mmn'") for line in lines)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="WORLD_SIZE=2 without RANK: start the processes "
                                         "with torchrun"):
        train_ddp.main(cfg, device="cpu")
    monkeypatch.delenv("WORLD_SIZE")
    cfg.distributed = True
    with pytest.raises(ValueError, match="distributed is set but WORLD_SIZE is not"):
        train_ddp.main(cfg, device="cpu")


def test_match_head_is_one_shot_and_chm_stays_unported():
    with pytest.raises(ValueError, match="shot=1 only"):
        HeadEngine(_cfg(opts=["shot", "2"]), "match", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        HeadEngine(_cfg(), "chm", device="cpu")
