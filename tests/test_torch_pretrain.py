"""The port's stage-1 pretraining against the JAX package, on the CPU
(ResNet-50 and VGG-16bn PSPNets, 33 px images, 4 classes, a batch of 3).

* ``smoothed_cross_entropy`` within 1e-6 relative.
* Two pretrain steps from the same perturbed weights (every BN field and
  the running statistics noised): label smoothing, then mixup, whose lambda
  and permutation the test recomputes from the JAX step's key by
  ``jax.random`` and injects. Dropout is 0 on both sides (the two
  packages' masks are different random streams). Weight decay 0.1, so
  ``gamma``, which no loss term reaches, moves by decay alone. Both steps
  run in float64 on both sides (the port's model in double, the JAX step
  under ``jax.enable_x64``): a train-mode step at a random init, 33 px and a
  batch of 3 is ill-conditioned in fp32 (BN over 27-75 values a channel;
  JAX's own fp32 VGG step lies 4e-3 of a tensor's largest entry from its
  x64 step, both ResNet-50 fp32 steps ~1e-2), so fp32 against fp32 would
  hold rounding, not the function. The JAX losses round the logits to fp32
  (``ops/losses.py``), as the port's do. The learning rate is the config's
  0.0025: after one step at 0.01 the stem's gradient is so sensitive that
  the fp32 rounding of the losses alone moves it by 1e-3 relative, even in
  float64. Losses within 1e-5 relative; after the
  second step every parameter and BN buffer within 1e-4 of its tensor's
  largest entry (the PPM's bin-1 running variance is over n = 3 values,
  where a torch-style unbiased update would be 3/2 of flax's); train I/U
  areas within 0.5% of the pixels. The port's fp32 first step: loss within
  1e-5 relative of the float64 JAX step's.
* Both parameter groups' learning rates at steps 0, 1 and the last, and
  the groups' sizes.
* ``standard_validate`` (5 records in batches of 2: a tail of 1) and
  ``episodic_validate`` (1 run x 3 episodes in batches of 2, classifier
  inits injected as JAX draws them) on the perturbed weights, fp32: mIoU
  within 2e-3 and loss within 1e-3 relative (fp32 sums in another order
  flip a few of the random init's near-tied pixels). One run: the JAX
  package's key folding overflows uint32 from run 1 on
  (``eval/validate.py:207-209``, ``(run * 1_000_003 + b) * 65_537``).
* ``StandardDataset`` on a tree the test writes: records equal to JAX's
  array for array, train (with the same ``random`` / ``np.random`` seeds)
  and val.
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from few_shot_seg_cwt_tpu.config import default_cfg as jax_default_cfg
from few_shot_seg_cwt_tpu.data import episodic as jax_episodic
from few_shot_seg_cwt_tpu.data.loader import EpisodeLoader as JaxLoader
from few_shot_seg_cwt_tpu.episodic.engine import EpisodicEngine as JaxEngine
from few_shot_seg_cwt_tpu.eval.validate import episodic_validate as jax_episodic_validate
from few_shot_seg_cwt_tpu.models.pspnet import build_pspnet as jax_build_pspnet
from few_shot_seg_cwt_tpu.models.pspnet import init_classifier_weights as jax_init_w
from few_shot_seg_cwt_tpu.ops.losses import smoothed_cross_entropy as jax_smoothed_ce
from few_shot_seg_cwt_tpu.train import common as jax_common
from few_shot_seg_cwt_tpu.train import pretrain as jax_pretrain
from few_shot_seg_cwt_tpu.train.optim import build_lr_schedule as jax_lr_schedule
from few_shot_seg_cwt_tpu_torch.config import default_cfg
from few_shot_seg_cwt_tpu_torch.data import episodic
from few_shot_seg_cwt_tpu_torch.data.loader import EpisodeLoader
from few_shot_seg_cwt_tpu_torch.episodic.engine import EpisodicEngine
from few_shot_seg_cwt_tpu_torch.eval.validate import episodic_validate
from few_shot_seg_cwt_tpu_torch.models.pspnet import build_pspnet
from few_shot_seg_cwt_tpu_torch.ops.losses import smoothed_cross_entropy
from few_shot_seg_cwt_tpu_torch.train import common
from few_shot_seg_cwt_tpu_torch.train.pretrain import (build_pretrain_optimizer,
                                                       make_pretrain_step, standard_validate)
from few_shot_seg_cwt_tpu_torch.utils.convert import pspnet_state_dict_from_flax
from test_torch_data import tree_cfgs, write_tree

torch.set_num_threads(1)

SIZE, B, K, ITERS = 33, 3, 4, 2


def _cfgs(**over):
    out = []
    for cfg in (jax_default_cfg(), default_cfg()):
        cfg.image_size, cfg.num_classes_tr, cfg.dropout = SIZE, K, 0.0
        cfg.smoothing, cfg.mixup, cfg.lr, cfg.scale_lr = True, False, 0.0025, 2.0
        cfg.weight_decay, cfg.epochs = 0.1, 1
        for k, v in over.items():
            cfg[k] = v
        out.append(cfg)
    return out


def _perturb(tree, rng):
    for node in tree.values():
        if not isinstance(node, dict):
            continue
        if "scale" in node:
            node["scale"] = node["scale"] * rng.uniform(0.5, 1.5, node["scale"].shape).astype(np.float32)
            node["bias"] = node["bias"] + rng.normal(0, 0.1, node["bias"].shape).astype(np.float32)
        if "mean" in node:
            node["mean"] = node["mean"] + rng.normal(0, 0.1, node["mean"].shape).astype(np.float32)
            node["var"] = node["var"] * rng.uniform(0.5, 1.5, node["var"].shape).astype(np.float32)
        _perturb(node, rng)
    return tree


def _batch(seed):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
    gt = rng.integers(0, K, (B, SIZE, SIZE)).astype(np.int32)
    gt[0, :5] = 255
    return img, gt


@pytest.fixture(scope="module", params=["resnet", "vgg"])
def arch(request):
    return request.param


@pytest.fixture(scope="module")
def weights(arch):
    jcfg, _ = _cfgs(arch=arch)
    model = jax_build_pspnet(jcfg)
    variables = jax.jit(lambda r, x: model.init({"params": r}, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    return model, _perturb(jax.tree.map(lambda x: np.array(x, np.float32), variables),
                           np.random.default_rng(2021))


@pytest.fixture(scope="module")
def jax_steps(arch, weights):
    """The JAX package's two steps (smoothing; smoothing + mixup) in float64
    and the mixup step's lambda and permutation, drawn from its key as it
    draws them."""
    model, variables = weights
    jcfg, _ = _cfgs(arch=arch)
    jcfg_mix, _ = _cfgs(arch=arch, mixup=True)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), variables)
        params, stats = v64["params"], v64["batch_stats"]
        opt = jax_pretrain.param_group_optimizer(jcfg, params, ITERS)
        state = opt.init(params)
        out = []
        for cfg, seed, key in ((jcfg, 1, jax.random.PRNGKey(11)),
                               (jcfg_mix, 2, jax.random.PRNGKey(12))):
            step = jax_pretrain.make_pretrain_step(model, opt, cfg)
            img, gt = _batch(seed)
            params, stats, state, m = step(params, stats, state,
                                           jnp.asarray(img, jnp.float64), jnp.asarray(gt), key)
            out.append({k: np.asarray(v) for k, v in m.items()})
        final = jax.tree.map(np.asarray, {"params": params, "batch_stats": stats})
        # under x64 the step draws lambda in float64: recompute it there
        _, rng_mix, rng_perm = jax.random.split(jax.random.PRNGKey(12), 3)
        lam = float(jax.random.beta(rng_mix, 0.2, 0.2))
        perm = np.asarray(jax.random.permutation(rng_perm, B))
    return out, lam, perm, final


@pytest.fixture(scope="module")
def port_steps(arch, weights, jax_steps):
    """The port's two steps in float64, and its fp32 first step's loss."""
    _, variables = weights
    _, lam, perm, _ = jax_steps

    def steps(dtype, mixup_step):
        _, tcfg = _cfgs(arch=arch)
        _, tcfg_mix = _cfgs(arch=arch, mixup=True)
        model = build_pspnet(tcfg)
        model.load_state_dict(pspnet_state_dict_from_flax(variables))
        model.to(dtype)
        optimizer, scheduler = build_pretrain_optimizer(model, tcfg, ITERS)
        img, gt = _batch(1)
        metrics = [make_pretrain_step(model, optimizer, scheduler, tcfg)(
            torch.from_numpy(img).to(dtype), torch.from_numpy(gt))]
        if mixup_step:
            img, gt = _batch(2)
            metrics.append(make_pretrain_step(model, optimizer, scheduler, tcfg_mix)(
                torch.from_numpy(img).to(dtype), torch.from_numpy(gt), lam=lam,
                perm=torch.from_numpy(perm.copy())))
        return model, [{k: v.numpy() for k, v in m.items()} for m in metrics]

    model, metrics = steps(torch.float64, True)
    return model, metrics, float(steps(torch.float32, False)[1][0]["loss"])


@pytest.mark.parametrize("smoothing", [0.1, 0.3])
def test_smoothed_cross_entropy_matches_jax(smoothing):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 9, 7, 6)) * 3).astype(np.float32)
    target = rng.integers(0, 6, (2, 9, 7)).astype(np.int32)
    target[1, :4] = 255
    want = float(jax_smoothed_ce(jnp.asarray(logits), jnp.asarray(target), 6, smoothing))
    got = float(smoothed_cross_entropy(torch.from_numpy(logits), torch.from_numpy(target),
                                       6, smoothing))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_pretrain_steps_match_jax(jax_steps, port_steps):
    want_metrics, lam, _, final = jax_steps
    model, got_metrics, loss32 = port_steps
    assert 0.0 < lam < 1.0
    for got, want in zip(got_metrics, want_metrics):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        for k in ("inter", "union", "target"):
            assert got[k].shape == want[k].shape == (K,), k
            np.testing.assert_allclose(got[k], want[k], atol=0.005 * B * SIZE * SIZE, err_msg=k)
    np.testing.assert_allclose(loss32, want_metrics[0]["loss"], rtol=1e-5)
    want_sd = pspnet_state_dict_from_flax(final)
    got_sd = model.state_dict()
    assert sorted(want_sd) == sorted(got_sd)
    for name, w in want_sd.items():
        if name.endswith("num_batches_tracked"):
            assert int(got_sd[name]) == 2, name
            continue
        # + 1e-12: VGG's conv biases feed a BN, so their gradient is zero
        # and both sides hold rounding noise of ~1e-18 there
        w = w.numpy()
        np.testing.assert_allclose(got_sd[name].numpy(), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()) + 1e-12, err_msg=name)
    # gamma moved by weight decay alone, as optax's add_decayed_weights moves it
    assert abs(float(got_sd["gamma"]) - 0.2) > 10 * 1e-4 * 0.2


def test_learning_rates_and_groups_match_jax(arch, weights):
    _, variables = weights
    jcfg, tcfg = _cfgs(arch=arch, epochs=2)
    model = build_pspnet(tcfg)
    optimizer, scheduler = build_pretrain_optimizer(model, tcfg, ITERS)
    labels = jax.tree_util.tree_map_with_path(
        lambda path, x: (path[0].key == "trunk", np.size(x)), variables["params"])
    sizes = {True: 0, False: 0}
    for is_trunk, n in jax.tree_util.tree_leaves(labels, is_leaf=lambda x: isinstance(x, tuple)):
        sizes[is_trunk] += n
    assert [sum(p.numel() for p in g["params"]) for g in optimizer.param_groups] == \
        [sizes[True], sizes[False]]
    bases = (jcfg.lr, jcfg.lr * jcfg.scale_lr)
    total = ITERS * jcfg.epochs
    for step in range(total + 1):
        if step in (0, 1, total):
            want = [jax_lr_schedule(jcfg, base, ITERS)(step) for base in bases]
            got = [g["lr"] for g in optimizer.param_groups]
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=f"step {step}")
        optimizer.step()
        scheduler.step()


class _Records:
    def __init__(self, n):
        rng = np.random.default_rng(8)
        self.items = [{"img": rng.standard_normal((SIZE, SIZE, 3)).astype(np.float32),
                       "label": rng.integers(0, K, (SIZE, SIZE)).astype(np.int32)}
                      for _ in range(n)]
        self.items[1]["label"][:6] = 255

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_standard_validate_matches_jax(arch, weights):
    model, variables = weights
    jcfg, tcfg = _cfgs(arch=arch)
    records = _Records(5)
    jloader = JaxLoader(records, batch_size=2, shuffle=False, num_workers=0, drop_last=False)
    want = jax_pretrain.standard_validate(jcfg, jax_pretrain.make_standard_eval(jcfg, model),
                                          variables["params"], variables["batch_stats"],
                                          jloader, log=lambda *_: None)
    port = build_pspnet(tcfg)
    port.load_state_dict(pspnet_state_dict_from_flax(variables))
    port.train()
    loader = EpisodeLoader(records, batch_size=2, shuffle=False, num_workers=0,
                           drop_last=False, device="cpu")
    got = standard_validate(tcfg, port, loader, log=lambda *_: None)
    assert port.training                       # the mode comes back
    np.testing.assert_allclose(got[0], want[0], atol=2e-3)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3)


class _InjectedInits:
    """The port engine's no-CWT program fed the classifier inits the JAX
    protocol draws, batch by batch in call order."""

    def __init__(self, engine, w0s):
        self.engine, self.w0s = engine, iter(w0s)

    def eval_metrics_batch_no_cwt(self, episodes, generator=None):
        return self.engine.eval_metrics_batch_no_cwt(episodes, w0=next(self.w0s))


def test_episodic_validate_matches_jax(arch, weights):
    _, variables = weights
    over = dict(arch=arch, num_classes_tr=2, adapt_iter=5, cls_lr=0.1, synthetic_data=True, test_num=3,
                episode_batch=2, n_runs=1, manual_seed=0, workers=0)
    jcfg, tcfg = _cfgs(**over)
    lines = []
    want = jax_episodic_validate(jcfg, JaxEngine(jcfg), variables,
                                 jax_common.episodic_val_loader(jcfg), log=lines.append)
    w0s = []
    for run in range(1):
        for b in range(2):
            keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0),
                                                       (run * 1_000_003 + b) * 65_537), 2)
            w0s.append(np.stack([np.asarray(jax_init_w(k, 2, 512)) for k in keys]))
    model = build_pspnet(_cfgs(arch=arch, num_classes_tr=K)[1])
    model.load_state_dict(pspnet_state_dict_from_flax(variables))
    engine = _InjectedInits(EpisodicEngine(tcfg, backbone=model, device="cpu"), w0s)
    got_lines = []
    got = episodic_validate(tcfg, engine, common.episodic_val_loader(tcfg, device="cpu"),
                            log=got_lines.append)
    assert len(got_lines) == len(lines) == 1
    np.testing.assert_allclose(got[0], want[0], atol=2e-3)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3)


@pytest.mark.parametrize("train", [False, True])
def test_standard_dataset_equals_jax(tmp_path, train):
    write_tree(tmp_path)
    jcfg, tcfg = tree_cfgs(tmp_path)
    random.seed(3)
    np.random.seed(3)
    jds = jax_episodic.StandardDataset(jcfg, train=train)
    ref = [jds[i] for i in range(len(jds))]
    random.seed(3)
    np.random.seed(3)
    tds = episodic.StandardDataset(tcfg, train=train)
    got = [tds[i] for i in range(len(tds))]
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g.keys() == r.keys() == {"img", "label"}
        for k in g:
            assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
    labels = np.concatenate([g["label"].ravel() for g in got])
    assert {0, 255} <= set(labels.tolist()) and labels.max() == 255
    assert set(labels.tolist()) - {0, 255}       # fold-local train classes
