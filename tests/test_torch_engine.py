"""PyTorch port vs the JAX package end to end: ResNet-50 PSPNet features,
weight conversion, and the eval/serve episode on the same weights and the
same classifier init (CPU, 33 px images -> 5x5 features, adapt_iter 5).

Weights: the JAX package's own init, with every BN mean/var/scale/bias and
LayerNorm scale/bias perturbed by seeded numpy noise, carried to the port by
``utils/convert.py``. Tolerances:

* ``extract_features``: rtol 1e-3, atol 1e-4 of the feature scale (fp32
  convolutions through 50 layers, summed in another order);
* ``pred_q``/``pred_q0``: rtol 1e-2, atol 2e-3 of the logit scale (the JAX
  suite's engine tolerance, tests/test_engine_parity.py:102-106), argmax
  agreement >= 99.5%;
* I/U areas: differ by at most the pixels whose predictions disagree.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from few_shot_seg_cwt_tpu.config import default_cfg as jax_default_cfg
from few_shot_seg_cwt_tpu.episodic.engine import EpisodicEngine as JaxEngine
from few_shot_seg_cwt_tpu.utils.ckpt import import_pspnet
from few_shot_seg_cwt_tpu_torch.config import default_cfg
from few_shot_seg_cwt_tpu_torch.data.synthetic import (SequentialBatches,
                                                       SyntheticEpisodicDataset,
                                                       make_episode_batch)
from few_shot_seg_cwt_tpu_torch.episodic.engine import EpisodicEngine
from few_shot_seg_cwt_tpu_torch.eval.validate import (exact_batch_sizes, fg_miou,
                                                      validate_transformer)
from few_shot_seg_cwt_tpu_torch.models.cwt import build_cwt
from few_shot_seg_cwt_tpu_torch.models.pspnet import build_pspnet
from few_shot_seg_cwt_tpu_torch.utils.convert import (cwt_state_dict_from_flax,
                                                      pspnet_state_dict_from_flax)

torch.set_num_threads(1)

SIZE, FEAT = 33, 5


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


def _cfgs():
    out = []
    for cfg in (jax_default_cfg(), default_cfg()):
        cfg.image_size = SIZE
        cfg.adapt_iter = 5
        cfg.cls_lr = 0.1
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def pair():
    """(JAX engine, its variables, port engine on the same weights)."""
    jcfg, tcfg = _cfgs()
    jeng = JaxEngine(jcfg)
    rng = np.random.default_rng(2021)
    vars_b = jax.jit(lambda r, x: jeng.backbone.init({"params": r}, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    vars_b = _perturb_norms(jax.tree.map(lambda x: np.array(x, np.float32), vars_b), rng)
    f = jnp.zeros((1, FEAT, FEAT, 512))
    vars_t = jax.jit(lambda r: jeng.cwt.init(r, jnp.zeros((1, 2, 512)), f, f))(
        jax.random.PRNGKey(1))
    vars_t = _perturb_norms(jax.tree.map(lambda x: np.array(x, np.float32), vars_t), rng)

    backbone = build_pspnet(tcfg)
    backbone.load_state_dict(pspnet_state_dict_from_flax(vars_b))
    cwt = build_cwt(tcfg)
    cwt.load_state_dict(cwt_state_dict_from_flax(vars_t))
    teng = EpisodicEngine(tcfg, backbone=backbone, cwt=cwt, device="cpu")
    return jeng, vars_b, vars_t, teng


@pytest.fixture(scope="module")
def episode():
    ep = make_episode_batch(3, 1, size=SIZE)
    ep = {k: v[0] for k, v in ep.items()}
    ep["s_label"][0, :4, :] = 255
    w0 = np.random.default_rng(9).uniform(-1 / np.sqrt(512), 1 / np.sqrt(512),
                                          (2, 512)).astype(np.float32)
    return ep, w0


@pytest.fixture(scope="module")
def jax_eval(pair, episode):
    jeng, vars_b, vars_t, _ = pair
    ep, w0 = episode
    jep = {k: jnp.asarray(ep[k]) for k in ("s_img", "s_label", "q_img", "q_label", "cls")}
    out = jax.jit(jeng.eval_episode_from_w0)(vars_b, vars_t, jep, jnp.asarray(w0))
    return {k: np.asarray(v) for k, v in out.items()}


def _scaled_close(got, ref, rtol, atol_frac):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol_frac * float(np.abs(ref).max()))


def test_extract_features_matches_jax(pair):
    jeng, vars_b, _, teng = pair
    x = np.random.default_rng(4).standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    ref, _ = jax.jit(lambda v, i: jeng.backbone.apply(
        v, i, train=False, method=jeng.backbone.extract_features))(vars_b, jnp.asarray(x))
    with torch.no_grad():
        got = teng.backbone.extract_features(torch.from_numpy(x))
    assert got.shape == (2, FEAT, FEAT, 512)
    _scaled_close(got.numpy(), ref, rtol=1e-3, atol_frac=1e-4)


def test_weights_round_trip_through_the_jax_importer(pair):
    """import_pspnet(port.state_dict()) gives back the flax variables: the
    port's names are the reference's, and no field is swapped or lost."""
    _, vars_b, _, teng = pair
    back = import_pspnet(teng.backbone.state_dict())
    for coll in ("params", "batch_stats"):
        want = jax.tree_util.tree_leaves_with_path(vars_b[coll])
        got = jax.tree_util.tree_leaves_with_path(back[coll])
        assert [p for p, _ in got] == [p for p, _ in want], coll
        for (_, g), (path, w) in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), w, err_msg=str(path))


def test_eval_episode_from_w0_matches_jax(pair, episode, jax_eval):
    _, _, _, teng = pair
    ep, w0 = episode
    out = teng.eval_episode_from_w0(ep, w0)
    for key in ("pred_q", "pred_q0"):
        got, ref = out[key].numpy(), jax_eval[key]
        assert got.shape == ref.shape == (FEAT, FEAT, 2)
        _scaled_close(got, ref, rtol=1e-2, atol_frac=2e-3)
        assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.995, key


def test_eval_episode_metrics_matches_jax(pair, episode, jax_eval):
    jeng, _, _, teng = pair
    ep, w0 = episode
    got = teng.eval_episode_metrics(ep, w0=w0)
    q_label = jnp.asarray(ep["q_label"])
    for suffix, key in (("", "pred_q"), ("0", "pred_q0")):
        inter, union, loss = jeng._upsampled_metrics(jnp.asarray(jax_eval[key]), q_label)
        d = np.asarray(jeng._upsampled_diff(jnp.asarray(jax_eval[key]), (SIZE, SIZE)))
        d_port = teng._upsampled_diff(teng.eval_episode_from_w0(ep, w0)[key][None],
                                      (SIZE, SIZE))[0].numpy()
        flips = int(((d > 0) != (d_port > 0)).sum())
        assert flips <= 0.005 * SIZE * SIZE, (suffix, flips)
        np.testing.assert_allclose(got[f"inter{suffix}"].numpy(), np.asarray(inter), atol=flips)
        np.testing.assert_allclose(got[f"union{suffix}"].numpy(), np.asarray(union), atol=flips)
        np.testing.assert_allclose(got[f"loss{suffix}"].numpy(), np.asarray(loss), rtol=1e-2)
    assert int(got["cls"]) == int(ep["cls"])


def test_serve_episode_matches_jax(pair, episode, jax_eval):
    jeng, _, _, teng = pair
    ep, w0 = episode
    mask = teng.serve_episode(ep, w0=w0).numpy()
    ref = np.asarray(jeng._upsampled_diff(jnp.asarray(jax_eval["pred_q"]), (SIZE, SIZE)) > 0)
    assert mask.shape == (SIZE, SIZE) and mask.dtype == np.int32
    assert set(np.unique(mask)) <= {0, 1}
    assert (mask == ref).mean() >= 0.995


def test_batched_programs_equal_single_episodes(pair):
    """eval_metrics_batch / serve_batch over E episodes equal E single-episode
    calls (the batch axis replaces the JAX package's vmap)."""
    _, _, _, teng = pair
    batch = make_episode_batch(5, 3, size=SIZE)
    w0 = teng.init_weights(3, torch.Generator().manual_seed(0))
    masks = teng.serve_batch(batch, w0=w0)
    metrics = teng.eval_metrics_batch(batch, w0=w0)
    for i in range(3):
        one = {k: v[i] for k, v in batch.items()}
        torch.testing.assert_close(teng.serve_episode(one, w0=w0[i]), masks[i])
        single = teng.eval_episode_metrics(one, w0=w0[i])
        for k in ("inter", "union", "inter0", "union0"):
            torch.testing.assert_close(single[k], metrics[k][i])
        torch.testing.assert_close(single["loss"], metrics["loss"][i], rtol=1e-5, atol=1e-6)
    # the generator path draws per-episode inits: same seed, same result
    a = teng.eval_metrics_batch(batch, torch.Generator().manual_seed(1))
    b = teng.eval_metrics_batch(batch, torch.Generator().manual_seed(1))
    torch.testing.assert_close(a["loss"], b["loss"])


def test_validate_transformer_scores_exactly_test_num(pair):
    """test_num 5 at episode_batch 2: three batches, the last with one
    filler episode that must not be scored."""
    _, _, _, teng = pair
    cfg = teng.cfg.clone()
    cfg.test_num, cfg.n_runs = 5, 1
    ds = SyntheticEpisodicDataset(cfg, length=8, seed=7)
    logs = []
    miou, loss = validate_transformer(cfg, teng, SequentialBatches(ds, 2), log=logs.append)
    assert exact_batch_sizes(5, 2) == [2, 2, 1]
    from collections import defaultdict

    from few_shot_seg_cwt_tpu_torch.eval.validate import accumulate_fg_iou, batch_generator

    inter, union = defaultdict(float), defaultdict(float)
    stream = iter(SequentialBatches(ds, 2))
    for b, n in enumerate([2, 2, 1]):
        out = teng.eval_metrics_batch(next(stream), batch_generator(cfg.manual_seed, 0, b))
        accumulate_fg_iou(inter, union, {k: v.numpy() for k, v in out.items()}, limit=n)
    assert miou == pytest.approx(fg_miou(inter, union), abs=1e-7)
    assert np.isfinite(loss)
    assert any(line.startswith("mIoU---Val result") for line in logs)


def test_entry_point_runs_on_cpu_and_refuses_real_data():
    from few_shot_seg_cwt_tpu_torch.train import test as entry

    _, cfg = _cfgs()
    cfg.adapt_iter = 2
    cfg.synthetic_data, cfg.test_num, cfg.n_runs, cfg.episode_batch = True, 3, 1, 2
    logs = []
    miou = entry.main(cfg, device="cpu", log=logs.append)
    assert 0.0 <= miou <= 1.0
    cfg.synthetic_data = False
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        entry.main(cfg, device="cpu", log=logs.append)


def test_multi_shot_episode_with_a_padded_shot_matches_jax(pair):
    """2 real shots + 1 all-255 padding shot through both engines."""
    jeng, vars_b, vars_t, teng = pair
    ep = {k: v[0] for k, v in make_episode_batch(8, 1, size=SIZE, shot=3).items()}
    ep["s_label"][2] = 255
    w0 = np.random.default_rng(10).uniform(-1 / np.sqrt(512), 1 / np.sqrt(512),
                                           (2, 512)).astype(np.float32)
    jep = {k: jnp.asarray(ep[k]) for k in ("s_img", "s_label", "q_img", "q_label", "cls")}
    ref = jax.jit(jeng.eval_episode_from_w0)(vars_b, vars_t, jep, jnp.asarray(w0))
    got = teng.eval_episode_from_w0(ep, w0)
    for key in ("pred_q", "pred_q0"):
        _scaled_close(got[key].numpy(), ref[key], rtol=1e-2, atol_frac=2e-3)
        assert (got[key].numpy().argmax(-1) == np.asarray(ref[key]).argmax(-1)).mean() >= 0.995
