"""The port's incremental CCA engine (``episodic/cca.py``) and its helpers
against the JAX package's, on the CPU: configs/pascal_cca.yaml (16-way
base classifier, ``rmid l34``, ``wt_dc``) at 33 px (5x5 features) with
adapt_iter 5.

Weights: the JAX backbone's and MMN head's variable trees drawn with numpy
(``test_torch_heads._seeded_variables``: BN fields around identity,
non-zero biases, the classifier N(0, 0.05)), the bottleneck's BN scaled by
1e-2 (features of norm ~10: at ~1e3 the 16-way softmax under
``compress_pred`` is one-hot in fp32 and every head gradient is exactly 0),
carried to the port by ``utils/convert.py``. The novel class's row: JAX draws it from the
episode's key, and the port is handed the same row (``new_row=``) or the
whole init (``w0=``). Tolerances:

* the helpers (``reset_spt_label``, ``compress_pred``, ``pred2bmask``,
  ``reset_cls_wt`` given the row, ``adapt_reset_spt_label_np``): equal;
* ``episode_parts`` on JAX's features: the pseudo-labels equal, the
  adapted classifier within 1e-5 of its scale; on its own features the
  pseudo-labels equal, the classifier within 1e-2;
* the loss tail on JAX's parts (1- and 2-shot, ``loss_shot sum``,
  ``aux``): loss within 1e-5 relative, the binary I/U equal; the eval
  program on JAX's parts: equal metrics, loss within 1e-5;
* the train step's head gradients on JAX's parts within 1e-4 of each
  tensor's largest entry under the JAX package's rank-4 and flat switches
  (the port's one path: the pivot pair's plain version on CPU tensors);
  end to end (the port's own
  features, 50 fp32 layers) within the MMN engine's 1e-3;
* ``adaptive_relabel_batch`` equal to JAX's bit for bit from the same
  ``np.random.Generator`` on the same base predictions; the port's base
  predictions within 1e-3 of the logit scale of JAX's.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from few_shot_seg_cwt_tpu.config import load_cfg as jax_load_cfg
from few_shot_seg_cwt_tpu.config import merge_cfg_from_list as jax_merge
from few_shot_seg_cwt_tpu.episodic import cca as jax_cca
from few_shot_seg_cwt_tpu.models.pspnet import apply_classifier as jax_apply_cls
from few_shot_seg_cwt_tpu.models.pspnet import effective_classifier_weight as jax_eff_w
from few_shot_seg_cwt_tpu.models.pspnet import init_classifier_weights as jax_init_w
from few_shot_seg_cwt_tpu.ops import episode_utils as jax_eu
from few_shot_seg_cwt_tpu.ops.resize import upsample_bilinear_ac as jax_up
from few_shot_seg_cwt_tpu_torch.config import load_cfg, merge_cfg_from_list
from few_shot_seg_cwt_tpu_torch.data.synthetic import make_episode_batch
from few_shot_seg_cwt_tpu_torch.episodic.cca import (CCAEngine, adaptive_relabel_batch,
                                                     make_base_preds_fn)
from few_shot_seg_cwt_tpu_torch.models.mmn import build_mmn
from few_shot_seg_cwt_tpu_torch.models.pspnet import build_pspnet
from few_shot_seg_cwt_tpu_torch.ops import episode_utils as eu
from few_shot_seg_cwt_tpu_torch.utils.convert import (mmn_state_dict_from_flax,
                                                      pspnet_state_dict_from_flax)
from test_torch_heads import _seeded_variables

torch.set_num_threads(1)

CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "pascal_cca.yaml")
SIZE, FEAT, E, K = 33, 5, 2, 16
OPTS = ["image_size", str(SIZE), "adapt_iter", "5"]
EP_KEYS = ("s_img", "s_label", "q_img", "q_label", "cls")
FLAT_SWITCHES = ("FSS_PIVOT_MXU", "FSS_PIVOT_PALLAS", "FSS_DISABLE_PALLAS", "FSS_NCONS_R4")


@pytest.fixture
def route(request, monkeypatch):
    for var in FLAT_SWITCHES:
        monkeypatch.delenv(var, raising=False)
    if request.param == "flat":
        monkeypatch.setenv("FSS_PIVOT_MXU", "1")
    return request.param


def _jcfg(opts=()):
    return jax_merge(jax_load_cfg(CONFIG), OPTS + list(opts))


def _tcfg(opts=()):
    return merge_cfg_from_list(load_cfg(CONFIG), OPTS + list(opts))


# --------------------------------------------------------------------------- #
# the helpers
# --------------------------------------------------------------------------- #

def test_reset_spt_label_equals_jax():
    rng = np.random.default_rng(0)
    s_label = rng.integers(0, 2, (2, 9, 11)).astype(np.int64)
    s_label[0, :2] = 255
    pred = rng.standard_normal((2, 9, 11, K)).astype(np.float32)
    for idx in (1, 5, 15):
        want = np.asarray(jax_eu.reset_spt_label(jnp.asarray(s_label), jnp.asarray(pred), idx))
        got = eu.reset_spt_label(torch.from_numpy(s_label), torch.from_numpy(pred), idx)
        np.testing.assert_array_equal(got.numpy(), want)
        # pixels pseudo-labelled 1 became idx too (the sequential semantics)
        assert not (got.numpy() == 1).any() or idx == 1


@pytest.mark.parametrize("input_type", ["lg", "pb"])
def test_compress_pred_and_pred2bmask_equal_jax(input_type):
    rng = np.random.default_rng(1)
    pred = rng.standard_normal((7, 5, K)).astype(np.float32)
    if input_type == "pb":
        pred = np.exp(pred) / np.exp(pred).sum(-1, keepdims=True)
    for idx in (0, 3):
        want = np.asarray(jax_eu.compress_pred(jnp.asarray(pred), idx, input_type))
        got = eu.compress_pred(torch.from_numpy(pred), idx, input_type).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(
            eu.pred2bmask(torch.from_numpy(pred), idx).numpy(),
            np.asarray(jax_eu.pred2bmask(jnp.asarray(pred), idx)))


def test_reset_cls_wt_equals_jax_given_the_row():
    rng = np.random.default_rng(2)
    weights = rng.standard_normal((K, 32)).astype(np.float32)
    pre = rng.standard_normal((K, 32)).astype(np.float32)
    want = np.asarray(jax_eu.reset_cls_wt(jnp.asarray(weights), jnp.asarray(pre), 12, 7,
                                          jax.random.PRNGKey(3)))
    got = eu.reset_cls_wt(torch.from_numpy(weights), torch.from_numpy(pre), 12, 7,
                          new_row=torch.from_numpy(want[7].copy()))
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = eu.reset_cls_wt(torch.from_numpy(weights), torch.from_numpy(pre), 12, 7,
                            generator=torch.Generator().manual_seed(0))
    assert float(drawn[7].abs().max()) <= 1 / np.sqrt(32)
    np.testing.assert_array_equal(drawn[12:].numpy(), weights[12:])


@pytest.mark.parametrize("shot,sub_cls", [(1, 3), (2, 5), (2, None)])
def test_adapt_reset_spt_label_equals_jax(shot, sub_cls):
    """Base predictions with classes large and small (the 300-pixel-a-shot
    threshold splits them), so the relabel inside the frequency loop runs."""
    rng = np.random.default_rng(shot * 10 + (sub_cls or 0))
    h = 40
    s_label = (rng.random((shot, h, h)) < 0.2).astype(np.int64)
    s_label[:, :3] = 255
    pred = rng.standard_normal((shot, h, h, K)).astype(np.float32)
    pred[:, :20, :, 2] += 5.0         # a class of ~600 px a shot
    pred[:, 20:30, :, 4] += 5.0       # ~300
    pred[:, 30:, :6, 9] += 5.0        # small
    pre_w = rng.standard_normal((K, 8)).astype(np.float32)
    want = jax_eu.adapt_reset_spt_label_np(s_label, pred.copy(), pre_w, K, sub_cls)
    got = eu.adapt_reset_spt_label_np(s_label, pred.copy(), pre_w, K, sub_cls)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[2] == want[2] and len(got[1]) == len(want[1]) == want[2] - 2
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def pair():
    """(JAX engine, backbone vars, head params, port engine on the same weights)."""
    jeng = jax_cca.CCAEngine(_jcfg())
    rng = np.random.default_rng(2021)
    vars_b = _seeded_variables(
        lambda r, x: jeng.backbone.init({"params": r}, x, train=False), rng, True,
        jnp.zeros((1, SIZE, SIZE, 3)))
    feats = {3: [jnp.zeros((1, FEAT, FEAT, 1024))] * 6, 4: [jnp.zeros((1, FEAT, FEAT, 2048))] * 3}
    f = jnp.zeros((1, FEAT, FEAT, 512))
    params = _seeded_variables(jeng.head.init, rng, False, feats, feats, f, f)["params"]
    # features of norm ~10, not ~1e3: the 16-way softmax that compress_pred
    # reads is then not one-hot in fp32, so the head's gradients are not 0
    for key in ("scale", "bias"):
        vars_b["params"]["bottleneck_bn"][key] = vars_b["params"]["bottleneck_bn"][key] * 0.01
    tcfg = _tcfg()
    backbone = build_pspnet(tcfg)
    backbone.load_state_dict(pspnet_state_dict_from_flax(vars_b))
    head = build_mmn(tcfg)
    head.load_state_dict(mmn_state_dict_from_flax(params))
    teng = CCAEngine(tcfg, backbone=backbone, head=head, device="cpu")
    return jeng, vars_b, params, teng


def _episodes(seed, shot, classes):
    batch = make_episode_batch(seed, len(classes), size=SIZE, shot=shot)
    batch = {k: batch[k] for k in EP_KEYS}
    batch["cls"] = np.asarray(classes, np.int32)     # within the 16-way classifier
    return batch


@pytest.fixture(scope="module")
def episodes():
    """1-shot and 2-shot batches of E episodes and one JAX key an episode."""
    one = _episodes(3, 1, [3, 14])
    one["s_label"][0, 0, :4, :] = 255
    two = _episodes(4, 2, [7, 1])
    rngs = jax.random.split(jax.random.PRNGKey(5), E)
    return {1: one, 2: two}, rngs


def _jax_episode(batch, i):
    return {k: jnp.asarray(v[i]) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_parts(pair, episodes):
    """Per shot count and episode: JAX's parts (the key as the train loss
    splits it), its novel row and its pseudo-labels."""
    jeng, vars_b, _, _ = pair
    batches, rngs = episodes
    parts_fn = jax.jit(lambda vb, ep, r: jeng.episode_parts(vb, ep, r))
    pre_w = jax_eff_w(vars_b["params"])
    out = {}
    for shot, batch in batches.items():
        rows = []
        for i in range(E):
            ep = _jax_episode(batch, i)
            rng_w = jax.random.split(rngs[i])[0]
            jp = jax.tree.map(np.asarray, parts_fn(vars_b, ep, rng_w))
            row = np.asarray(jax_init_w(jax.random.split(rng_w)[0], 1, 512)[0])
            base = jax_up(jax_apply_cls(pre_w, jnp.asarray(jp["f_s"])), (SIZE, SIZE))
            label = np.asarray(jax_eu.reset_spt_label(ep["s_label"], base, int(batch["cls"][i])))
            rows.append((jp, row, label))
        out[shot] = rows
    return out


def _port_part(jp, stages):
    """JAX's per-episode parts as the port's per-episode parts."""
    t = lambda x: torch.from_numpy(np.array(x))   # noqa: E731
    return dict(f_s=t(jp["f_s"]), f_q=t(jp["f_q"]),
                fs_feats={k: [t(a) for a in jp["fs_feats"][k]] for k in stages},
                fq_feats={k: [t(a) for a in jp["fq_feats"][k]] for k in stages},
                w=t(jp["w"]), fg_idx=torch.tensor(int(jp["fg_idx"])),
                row_mask=t(jp["row_mask"]) if "row_mask" in jp else None,
                pd_q0=t(jp["pd_q0"]), pd_s=t(jp["pd_s"]), s_label=None)


def _port_episode(batch, i):
    return {k: torch.from_numpy(np.asarray(v[i])).long() if k != "s_img" and k != "q_img"
            else torch.from_numpy(np.asarray(v[i])) for k, v in batch.items()}


def _jax_features(rows, stages):
    """JAX's backbone output for a batch, in the port's image order (every
    support, then every query), as ``extract_features`` returns it."""
    t = lambda x: torch.from_numpy(np.array(x))   # noqa: E731
    feat = torch.cat([t(jp["f_s"]) for jp, _, _ in rows] + [t(jp["f_q"]) for jp, _, _ in rows])
    feats = {k: [torch.cat([t(jp["fs_feats"][k][j]) for jp, _, _ in rows]
                           + [t(jp["fq_feats"][k][j]) for jp, _, _ in rows])
                 for j in range(len(rows[0][0]["fs_feats"][k]))] for k in stages}
    return feat, feats


@pytest.mark.parametrize("shot", [1, 2])
def test_episode_parts_match_jax(pair, episodes, jax_parts, shot, monkeypatch):
    """On JAX's features (the backbone's output handed over): the
    pseudo-labels equal, the adapted classifier within 1e-5 of its scale,
    the raw predictions within 1e-5 of theirs (measured: 1.7e-6 after the
    five steps, 4.5e-7 after one). End to end (the port's own
    features): the pseudo-labels still equal, the classifier within 1e-2 of
    its scale (five steps at cls_lr 0.1 amplify the features' fp32
    differences)."""
    _, _, _, teng = pair
    batches, _ = episodes
    batch = teng.to_device(batches[shot])
    rows = torch.from_numpy(np.stack([r for _, r, _ in jax_parts[shot]]))
    own = teng.episode_parts(batch, new_row=rows)
    feats = _jax_features(jax_parts[shot], teng._stages())
    monkeypatch.setattr(teng.backbone, "extract_features", lambda imgs: feats)
    parts = teng.episode_parts(batch, new_row=rows)
    for i, (jp, _, label) in enumerate(jax_parts[shot]):
        np.testing.assert_array_equal(parts["s_label"][i].numpy(), label)
        np.testing.assert_array_equal(own["s_label"][i].numpy(), label)
        w = jp["w"]
        np.testing.assert_allclose(parts["w"][i].numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()))
        np.testing.assert_allclose(own["w"][i].numpy(), w, rtol=0,
                                   atol=1e-2 * float(np.abs(w).max()))
        for key, got in (("pd_q0", parts["pd_q0"][i:i + 1]), ("pd_s", parts["pd_s"][i])):
            np.testing.assert_allclose(got.numpy(), jp[key], rtol=0,
                                       atol=1e-5 * float(np.abs(jp[key]).max()), err_msg=key)
        assert int(parts["fg_idx"][i]) == int(jp["fg_idx"]) == int(batch["cls"][i])
    # the same init given whole: the stage-1 rows with the novel row set
    w0 = teng.base_weight().expand(E, K, 512).clone()
    w0[torch.arange(E), batch["cls"]] = rows
    again = teng.episode_parts(batch, w0=w0)
    torch.testing.assert_close(again["w"], parts["w"], rtol=0, atol=0)


def _jax_loss(jcfg, vars_b, params, jp, ep, rng, det, grad=False):
    """JAX's CCA loss on the given parts (its episode_parts replaced)."""
    jeng = jax_cca.CCAEngine(jcfg)
    jeng.episode_parts = lambda vb, e, r, s_label_override=None: jax.tree.map(jnp.asarray, jp)
    if grad:
        return jax.jit(jax.grad(lambda p: jeng.train_episode_loss(p, vars_b, ep, rng)[0]))(
            params)
    return jax.jit(lambda p: jeng.train_episode_loss(p, vars_b, ep, rng, det=det))(params)


@pytest.mark.parametrize("shot,opts", [(1, ()), (2, ()), (2, ("loss_shot", "sum")),
                                       (1, ("aux", "0.5"))])
def test_loss_on_jax_parts_matches_jax(pair, episodes, jax_parts, shot, opts, monkeypatch):
    jeng, vars_b, params, teng = pair
    batches, rngs = episodes
    for k, v in zip(opts[::2], opts[1::2]):
        monkeypatch.setitem(teng.cfg, k, type(teng.cfg.get(k, v))(v) if k != "aux" else float(v))
    for i, (jp, _, _) in enumerate(jax_parts[shot]):
        ep = _jax_episode(batches[shot], i)
        want_loss, want = _jax_loss(_jcfg(opts), vars_b, params, jp, ep, rngs[i], det=True)
        loss, got = teng.train_episode_loss(_port_part(jp, teng._stages()),
                                            _port_episode(batches[shot], i), deterministic=True)
        np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
        for name in ("inter", "union", "inter0", "union0", "inter1", "union1"):
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]),
                                          err_msg=name)


def test_eval_program_on_jax_parts_matches_jax(pair, episodes, jax_parts, monkeypatch):
    """``eval_metrics_batch`` (one episode at a time, ``cls`` out) on JAX's
    parts against JAX's ``eval_metrics_batch`` itself, which computes its
    own: so the parts JAX's eval program made are the ones handed over."""
    jeng, vars_b, params, teng = pair
    batches, rngs = episodes
    batch = batches[1]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    # the eval program splits each episode's key as the train loss does
    want = {k: np.asarray(v) for k, v in jeng.eval_metrics_batch(
        params, vars_b, jb, rngs, None).items()}
    stages = teng._stages()
    parts = [_port_part(jp, stages) for jp, _, _ in jax_parts[1]]
    stacked = {k: (torch.stack([p[k] for p in parts]) if torch.is_tensor(parts[0][k]) else
                   {s: [torch.stack([p[k][s][j] for p in parts]) for j in range(len(v))]
                    for s, v in parts[0][k].items()} if isinstance(parts[0][k], dict) else None)
               for k in parts[0]}
    stacked["f_q"] = stacked["f_q"][:, 0]
    stacked["fq_feats"] = {s: [t[:, 0] for t in v] for s, v in stacked["fq_feats"].items()}
    stacked["pd_q0"] = stacked["pd_q0"][:, 0]
    stacked["s_label"] = torch.from_numpy(batch["s_label"]).long()
    monkeypatch.setattr(teng, "_prologue", lambda b, g, w0, shard=(0, 1): stacked)
    got = teng.eval_metrics_batch(batch, w0=torch.zeros(E, K, 512))
    np.testing.assert_array_equal(got["cls"].numpy(), want["cls"])
    np.testing.assert_allclose(got["loss"].numpy(), want["loss"], rtol=1e-5)
    for name in ("inter", "union", "inter0", "union0", "inter1", "union1"):
        np.testing.assert_array_equal(got[name].numpy(), want[name], err_msg=name)


@pytest.mark.parametrize("route", ["flat", "r4"], indirect=True)
@pytest.mark.parametrize("shot", [1, 2])
def test_train_step_gradients_on_jax_parts_match_jax(pair, episodes, jax_parts, route, shot):
    jeng, vars_b, params, teng = pair
    batches, rngs = episodes
    jp = jax_parts[shot][0][0]
    ep = _jax_episode(batches[shot], 0)
    want = mmn_state_dict_from_flax(jax.tree.map(np.asarray, _jax_loss(
        _jcfg(), vars_b, params, jp, ep, rngs[0], det=False, grad=True)))
    teng.head.zero_grad(set_to_none=True)
    loss, _ = teng.train_episode_loss(_port_part(jp, teng._stages()),
                                      _port_episode(batches[shot], 0))
    loss.backward()
    grads = {k: p.grad for k, p in teng.head.named_parameters()}
    assert sorted(grads) == sorted(want)
    for name, w in want.items():
        w = w.numpy()
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(grads[name].numpy(), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()), err_msg=name)


@pytest.mark.parametrize("route", ["flat", "r4"], indirect=True)
def test_train_step_end_to_end_matches_jax(pair, episodes, jax_parts, route):
    """``backward_batch`` from the images (the port's own features and inner
    loop) with JAX's init injected as ``w0``: the head gradients within the
    MMN engine's 1e-3 of each tensor's largest entry."""
    jeng, vars_b, params, teng = pair
    batches, rngs = episodes
    batch = batches[1]
    jp, row, _ = jax_parts[1][0]
    ep = _jax_episode(batch, 0)
    jeng_grad = jax.jit(jax.grad(lambda p: jeng.train_episode_loss(p, vars_b, ep, rngs[0])[0]))
    want = mmn_state_dict_from_flax(jax.tree.map(np.asarray, jeng_grad(params)))
    w0 = teng.base_weight().clone()
    w0[int(batch["cls"][0])] = torch.from_numpy(row)
    one = {k: v[:1] for k, v in batch.items()}
    metrics = teng.backward_batch(one, w0=w0[None], deterministic=True)
    assert torch.isfinite(metrics["loss_mean"]) and metrics["inter1"].shape == (1, 2)
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(teng.head.get_parameter(name).grad.numpy(), w, rtol=0,
                                   atol=1e-3 * float(np.abs(w).max()), err_msg=name)


# --------------------------------------------------------------------------- #
# cca1: the adaptive host pass
# --------------------------------------------------------------------------- #

def test_adaptive_relabel_batch_equals_jax(pair, episodes):
    """The same base predictions and the same ``np.random.Generator``:
    labels, inits and row masks equal JAX's bit for bit (``load_bg`` on,
    so the BG row is inherited too); the port's own base predictions
    within 1e-3 of the logit scale of JAX's."""
    jeng, vars_b, _, teng = pair
    batch = episodes[0][2]
    jcfg, tcfg = _jcfg(["load_bg", "True"]), _tcfg(["load_bg", "True"])
    jfn = jax_cca.make_base_preds_fn(jcfg, jeng)
    jpreds = [np.asarray(jfn(vars_b, jnp.asarray(batch["s_img"][i]))) for i in range(E)]
    tfn = make_base_preds_fn(tcfg, teng)
    for i in range(E):
        got = tfn(batch["s_img"][i]).numpy()
        np.testing.assert_allclose(got, jpreds[i], rtol=0,
                                   atol=1e-3 * float(np.abs(jpreds[i]).max()))
    calls = iter(range(E))
    want = jax_cca.adaptive_relabel_batch(
        jcfg, jeng, vars_b, dict(batch), lambda vb, s: jpreds[next(calls)],
        np.random.default_rng(7))
    calls = iter(range(E))
    got = adaptive_relabel_batch(tcfg, teng, dict(batch), lambda s: jpreds[next(calls)],
                                 np.random.default_rng(7))
    for k in ("s_label", "w0", "row_mask"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["row_mask"].sum(-1) >= 2).all()


def test_adaptive_engine_on_jax_parts_matches_jax(pair, episodes, monkeypatch):
    """cca1's engine on JAX's features: the relabelled support, the
    inherited rows and the row mask through the K-way loop (within 1e-5 of
    the classifier's scale) and the masked loss, against JAX's."""
    jeng, vars_b, params, teng = pair
    batch = episodes[0][1]
    tcfg, jcfg = _tcfg(), _jcfg()
    fn = make_base_preds_fn(tcfg, teng)
    relabelled = adaptive_relabel_batch(tcfg, teng, dict(batch), fn, np.random.default_rng(3))
    j1 = jax_cca.CCAEngine(jcfg, adaptive=True)
    t1 = CCAEngine(tcfg, adaptive=True, backbone=teng.backbone, head=teng.head, device="cpu")
    jps = [(jax.tree.map(np.asarray, jax.jit(lambda vb, e, r: j1.episode_parts(vb, e, r))(
        vars_b, _jax_episode(relabelled, i), jax.random.PRNGKey(i))), None, None)
        for i in range(E)]
    feats = _jax_features(jps, t1._stages())
    monkeypatch.setattr(t1.backbone, "extract_features", lambda imgs: feats)
    parts = t1.episode_parts(t1.to_device(relabelled))
    for i in range(E):
        ep = _jax_episode(relabelled, i)
        jp = jps[i][0]
        w = jp["w"]
        np.testing.assert_allclose(parts["w"][i].numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()))
        np.testing.assert_array_equal(parts["row_mask"][i].numpy(), jp["row_mask"])
        want_loss, want = _jax_loss(jcfg, vars_b, params, jp, ep, jax.random.PRNGKey(i), True)
        loss, got = t1.train_episode_loss(_port_part(jp, t1._stages()),
                                          _port_episode(relabelled, i), deterministic=True)
        np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
        for name in ("inter", "union", "inter1", "union1"):
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


# --------------------------------------------------------------------------- #
# inherit_base
# --------------------------------------------------------------------------- #

def test_inherit_base_val_classifier_matches_jax():
    """``inherit_base``: the (K + 1)-way ``val_classifier`` carried across by
    ``pspnet_state_dict_from_flax`` and read back by the JAX importer;
    ``classify_val`` on the same features within 1e-5 of JAX's."""
    from few_shot_seg_cwt_tpu.models.pspnet import build_pspnet as jax_build
    from few_shot_seg_cwt_tpu.utils.ckpt import import_pspnet

    jcfg, tcfg = _jcfg(["inherit_base", "True"]), _tcfg(["inherit_base", "True"])
    jmodel = jax_build(jcfg)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda r, x: jmodel.init({"params": r}, x, train=False))(
        jax.random.PRNGKey(1), jnp.zeros((1, SIZE, SIZE, 3))))
    # flax creates the head's parameters where a method first calls it
    val = jmodel.init(jax.random.PRNGKey(2), jnp.zeros((1, FEAT, FEAT, 512)), (SIZE, SIZE),
                      method=jmodel.classify_val)
    variables["params"]["val_classifier"] = jax.tree.map(
        np.asarray, val["params"]["val_classifier"])
    assert variables["params"]["val_classifier"]["weight"].shape == (512, K + 1)
    port = build_pspnet(tcfg)
    sd = pspnet_state_dict_from_flax(variables)
    port.load_state_dict(sd)
    back = import_pspnet({k: v.numpy() for k, v in sd.items()})
    np.testing.assert_array_equal(back["params"]["val_classifier"]["weight"],
                                  variables["params"]["val_classifier"]["weight"])
    feat = np.random.default_rng(0).standard_normal((2, FEAT, FEAT, 512)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(feat), (SIZE, SIZE),
                                   method=jmodel.classify_val))
    with torch.no_grad():
        got = port.classify_val(torch.from_numpy(feat), (SIZE, SIZE)).numpy()
    assert got.shape == want.shape == (2, SIZE, SIZE, K + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


def test_serve_masks_are_the_eval_predictions(pair, episodes):
    """``serve_batch`` reads no query label and gives the argmax of the
    blended compressed prediction; its I/U against the labels are the
    eval program's (the same generator draws the same novel rows)."""
    from few_shot_seg_cwt_tpu_torch.ops.metrics import intersection_and_union

    _, _, _, teng = pair
    batch = episodes[0][1]
    masks = teng.serve_batch({k: v for k, v in batch.items() if k != "q_label"},
                             torch.Generator().manual_seed(4))
    assert masks.shape == (E, SIZE, SIZE) and masks.dtype == torch.int32
    out = teng.eval_metrics_batch(batch, torch.Generator().manual_seed(4))
    for i in range(E):
        inter, union, _ = intersection_and_union(masks[i].long(),
                                                 torch.from_numpy(batch["q_label"][i]).long(), 2)
        assert torch.equal(inter, out["inter"][i]) and torch.equal(union, out["union"][i])
