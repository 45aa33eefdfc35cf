"""The port's fusion head against the JAX package, on the CPU:
``avg_pool_2x2``, ``DynamicFusion``, ``FuseNet1`` and ``FuseNet`` (their
``_Conv4dStack`` on the 6D route, support stride 2), the ``fuse``
``HeadEngine`` on configs/pascal_fuse.yaml as shipped with its frozen
MatchNet under the JAX package's rank-4 and flat switches (eval and serve
predictions, the train step's loss and FuseNet1's gradients), the chain
``train_match`` -> ``best.pt`` -> ``matchnet_ckpt`` read by both packages'
``init_frozen_match`` -> the same fuse loss, ``train_fuse.main`` with exact
resume, ``export_serve --head fuse``, ``BENCH_HEAD=fuse``, and the dryrun's
world-2 rows for the att, asy and fuse steps.

Weights: the JAX modules' trees drawn from a numpy seed over the shapes
``jax.eval_shape`` gives (positive consensus biases in the frozen MatchNet:
a zero-bias random consensus can be dead), carried to the port by
``utils/convert.py``; each JAX reference is one jitted program. The engine
runs at 33 px (feature side 5, im_size 3) and adapt_iter 5, one torch
thread; the JAX prologue runs once per episode and its ``_loss_fuse`` on
those parts (its default rank-4 route), the port's engine end to end under
each switch (its one path runs the pivot pair's plain version on CPU
tensors) with the JAX classifier-init draw of each episode as ``w0``.
Tolerances: module outputs within 1e-5 * max|ref| (gradients of the
outputs' squares within 1e-3 * max|g| per tensor); the engine's
predictions within 1e-4 * max|ref|; train-step gradients within 1e-3 *
max|g| per tensor.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from few_shot_seg_cwt_tpu.config import load_cfg as jax_load_cfg
from few_shot_seg_cwt_tpu.config import merge_cfg_from_list as jax_merge
from few_shot_seg_cwt_tpu.episodic.heads import HeadEngine as JaxHeadEngine
from few_shot_seg_cwt_tpu.models import fusion as jfu
from few_shot_seg_cwt_tpu.models.pspnet import init_classifier_weights as jax_init_w
from few_shot_seg_cwt_tpu.train.train_head import init_frozen_match as jax_init_frozen_match
from few_shot_seg_cwt_tpu_torch.config import load_cfg, merge_cfg_from_list
from few_shot_seg_cwt_tpu_torch.data.synthetic import make_episode_batch
from few_shot_seg_cwt_tpu_torch.episodic.heads import HeadEngine, build_head
from few_shot_seg_cwt_tpu_torch.models import fusion as tfu
from few_shot_seg_cwt_tpu_torch.models.matching import MatchNet
from few_shot_seg_cwt_tpu_torch.models.pspnet import build_pspnet
from few_shot_seg_cwt_tpu_torch.utils import tracing
from few_shot_seg_cwt_tpu_torch.tools import export_serve, serve_loaded
from few_shot_seg_cwt_tpu_torch.train.train_head import init_frozen_match
from few_shot_seg_cwt_tpu_torch.utils.convert import (fuse_state_dict_from_flax,
                                                      matchnet_state_dict_from_flax,
                                                      pspnet_state_dict_from_flax)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FUSE_CONFIG = str(ROOT / "configs" / "pascal_fuse.yaml")
MATCH_CONFIG = str(ROOT / "configs" / "pascal_match.yaml")
SIZE, E = 33, 2
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


def _fwd_close(got, want, frac=1e-5):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * float(np.abs(want).max()))


def _grads(module):
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p))
            for k, p in module.named_parameters()}


def _grads_close(got, want, label=""):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = np.asarray(w)
        top = float(np.abs(w).max())
        assert top > 0, f"{label} {name}"
        np.testing.assert_allclose(got[name].detach().numpy(), w, rtol=0, atol=1e-3 * top,
                                   err_msg=f"{label} {name}")


def _draw(rng, path, shape):
    names = [getattr(k, "key", str(k)) for k in path]
    if names[-1] == "kernel":
        return rng.uniform(-1, 1, shape) / np.sqrt(np.prod(shape[:-1]))
    if names[-1] == "bias" and "ncons" in names:
        return rng.uniform(0.05, 0.15, shape)
    return rng.normal(0, 0.05, shape)


def _drawn(init, rng, *args):
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)["params"]
    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(_draw(rng, p, s.shape), np.float32), shapes)


def _jax_out_and_grads(mod, params, *args):
    def f(p):
        out = mod.apply({"params": p}, *args)
        return jnp.sum(out ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    return np.asarray(out), jax.tree.map(np.asarray, grads)


def _module_parity(jmod, tmod, *args):
    jargs = jax.tree.map(jnp.asarray, args)
    params = _drawn(jmod.init, np.random.default_rng(51), *jargs)
    want, grads = _jax_out_and_grads(jmod, params, *jargs)
    tmod.load_state_dict(fuse_state_dict_from_flax(params))
    out = tmod(*jax.tree.map(torch.from_numpy, args))
    _fwd_close(out, want)
    (out ** 2).sum().backward()
    _grads_close(_grads(tmod), fuse_state_dict_from_flax(grads))


# --------------------------------------------------------------------------- #
# the fusion modules
# --------------------------------------------------------------------------- #


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_avg_pool_2x2_matches_jax():
    x = _f32(np.random.default_rng(50), 2, 7, 6, 3)
    _fwd_close(tfu.avg_pool_2x2(torch.from_numpy(x)), jfu.avg_pool_2x2(jnp.asarray(x)))


def test_dynamic_fusion_matches_jax():
    rng = np.random.default_rng(52)
    corr, s_mask = _f32(rng, 2, 6, 6, 6, 6), rng.random((2, 6, 6, 1)).astype(np.float32)
    _module_parity(jfu.DynamicFusion(im_size=3, mid_dim=8), tfu.DynamicFusion(3, 8), corr,
                   s_mask)


@pytest.mark.parametrize("mask_side", [6, 3])
def test_fusenet1_matches_jax(mask_side):
    """Two correlations through the shared stack (1 -> 16 at support stride
    2, then 16 -> 1), the support mask (pooled when twice im_size), two
    2-channel prediction maps."""
    rng = np.random.default_rng(53)
    corrs = [_f32(rng, 2, 6, 6, 6, 6) for _ in range(2)]
    s_mask = rng.random((2, mask_side, mask_side, 1)).astype(np.float32)
    pds = [_f32(rng, 2, 6, 6, 2) for _ in range(2)]
    _module_parity(jfu.FuseNet1(im_size=3, mid_dim=8),
                   tfu.FuseNet1(3, 8, pd_channels=4), corrs, s_mask, pds)


def test_fusenet_matches_jax():
    rng = np.random.default_rng(54)
    args = (_f32(rng, 2, 6, 6, 6, 6), _f32(rng, 2, 6, 6, 2), _f32(rng, 2, 9), _f32(rng, 2, 9),
            rng.random((2, 3, 3, 1)).astype(np.float32))
    _module_parity(jfu.FuseNet(im_size=3, mid_dim=8), tfu.FuseNet(3, 8, pd_channels=2), *args)


def test_fuse_head_stack_runs_the_6d_route():
    """The stack's blocks: 1 -> 16 at support stride (1, 1, 2, 2) and 16 -> 1
    at stride 1, called without flat_dims (the 6D route: no pivot kernel
    whatever the switches); 473 px gives im_size 30."""
    cfg = merge_cfg_from_list(load_cfg(FUSE_CONFIG), ["image_size", "473"])
    head = build_head(cfg, "fuse")
    c0, c1 = head.conv4d[0], head.conv4d[2]
    assert (c0.conv1.in_channels, c0.out_channels, c0.stride) == (1, 16, (1, 1, 2, 2))
    assert (c1.conv1.in_channels, c1.out_channels, c1.stride) == (16, 1, (1, 1, 1, 1))
    assert head.im_size == 30 and head.att[0].in_channels == 3 * 900 + 4


# --------------------------------------------------------------------------- #
# the fuse head engine
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


def _frozen_init(jeng):
    return lambda r, c, v: jeng.frozen_match.init(r, c, v, method=jeng.frozen_match.corr_forward)


@pytest.fixture(scope="module")
def fuse_setup():
    """The JAX engine, backbone, episodes, per-episode parts, w0, rngs, the
    drawn FuseNet1 and frozen MatchNet trees, and the per-episode JAX
    (loss, preds, grads as a port state_dict)."""
    jeng = JaxHeadEngine(jax_merge(jax_load_cfg(FUSE_CONFIG), OPTS), "fuse")
    rng = np.random.default_rng(2026)
    vars_b = _seeded_backbone(lambda r, x: jeng.backbone.init({"params": r}, x, train=False),
                              rng, jnp.zeros((1, SIZE, SIZE, 3)))
    batch = make_episode_batch(23, E, size=SIZE)
    batch = {k: batch[k] for k in EP_KEYS}
    rngs = jax.random.split(jax.random.PRNGKey(12), E)
    w0 = np.stack([np.array(jax_init_w(r, 2, 512)) for r in rngs])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    parts_fn = jax.jit(lambda ep, r: jeng.episode_parts(vars_b, ep, r))
    eps = [{k: v[i] for k, v in jbatch.items()} for i in range(E)]
    parts = [parts_fn(eps[i], rngs[i]) for i in range(E)]
    h, im = parts[0]["f_q"].shape[1], jeng.head.im_size
    corr, pd = jnp.zeros((1, h, h, h, h)), jnp.zeros((1, h, h, 2))
    params = _drawn(jeng.head.init, np.random.default_rng(2027), [corr, corr],
                    jnp.zeros((1, im, im, 1)), [pd, pd])
    # the prediction maps enter the MLP as logits of ~50 (the seeded
    # backbone's scale): a last layer of the drawn scale would saturate the
    # 2-way softmax, and every gradient would round to 0
    params["att"]["att1"]["kernel"] *= 1e-3
    frozen = {"params": _drawn(_frozen_init(jeng), np.random.default_rng(2028),
                               corr[..., None], jnp.zeros((1, h, h, 512)))}

    def loss(p, part, ep, r, fv):
        return jeng._loss_fuse({"params": p}, part, ep, r, fv, det=True)

    fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
    want = []
    for i in range(E):
        (value, preds), grads = fn(jax.tree.map(jnp.asarray, params), parts[i], eps[i],
                                   rngs[i], frozen)
        want.append((float(value), {k: np.asarray(v) for k, v in preds.items()},
                     fuse_state_dict_from_flax(jax.tree.map(np.asarray, grads))))
    return dict(jeng=jeng, vars_b=vars_b, batch=batch, eps=eps, parts=parts, w0=w0, rngs=rngs,
                params=params, frozen=frozen, want=want, fn=fn)


def _port_engine(setup, cfg=None):
    cfg = cfg or merge_cfg_from_list(load_cfg(FUSE_CONFIG), OPTS)
    backbone = build_pspnet(cfg)
    backbone.load_state_dict(pspnet_state_dict_from_flax(setup["vars_b"], dist=cfg.dist))
    head = build_head(cfg, "fuse")
    head.load_state_dict(fuse_state_dict_from_flax(setup["params"]))
    frozen = MatchNet(temp=cfg.temp, cv_type="red", in_channel=1)
    frozen.load_state_dict(matchnet_state_dict_from_flax(setup["frozen"]))
    return HeadEngine(cfg, "fuse", backbone=backbone, head=head, frozen_match=frozen,
                      device="cpu")


@pytest.mark.parametrize("route", ["r4", "flat"], indirect=True)
def test_fuse_eval_and_serve_match_jax(fuse_setup, route):
    """eval_metrics_batch, predict_batch and serve_batch against the JAX
    ``_loss_fuse`` on the same parts; the frozen MatchNet's consensus on
    the route in effect (the pivot pair's plain version on the flat route:
    no launch is counted on CPU tensors)."""
    teng = _port_engine(fuse_setup)
    batch, w0 = fuse_setup["batch"], torch.from_numpy(fuse_setup["w0"])
    before = tracing.counts()
    got = teng.predict_batch(batch, w0=w0)
    metrics = teng.eval_metrics_batch(batch, w0=w0)
    masks = teng.serve_batch(batch, w0=w0)
    assert tracing.counts() == before
    assert masks.shape == (E, SIZE, SIZE) and masks.dtype == torch.int32
    for i, (_, preds, _) in enumerate(fuse_setup["want"]):
        for key in ("pred1", "pred"):
            assert got[key][i].shape == (SIZE, SIZE, 2)
            _fwd_close(got[key][i], preds[key], 1e-4)
        assert torch.equal(masks[i], got["pred"][i].argmax(-1).int())
        assert bool(torch.isfinite(metrics["loss"][i]))
    one = teng.serve_episode({k: v[1] for k, v in batch.items()}, w0=fuse_setup["w0"][1])
    assert torch.equal(one, masks[1])


@pytest.mark.parametrize("route", ["r4", "flat"], indirect=True)
def test_fuse_train_step_matches_jax(fuse_setup, route):
    """Each episode's disagreement loss and FuseNet1's gradients against
    jax.grad of the JAX loss; the frozen MatchNet takes none and stays out
    of the head's state_dict."""
    teng = _port_engine(fuse_setup)
    frozen_before = {k: v.clone() for k, v in teng.frozen_match.state_dict().items()}
    batch, w0 = fuse_setup["batch"], fuse_setup["w0"]
    for i, (want_loss, _, grads) in enumerate(fuse_setup["want"]):
        one = {k: v[i:i + 1] for k, v in batch.items()}
        metrics = teng.backward_batch(one, w0=torch.from_numpy(w0[i:i + 1]), deterministic=True)
        np.testing.assert_allclose(float(metrics["loss_mean"]), want_loss, rtol=1e-4)
        _grads_close(_grads(teng.head), grads, label=str(i))
    assert all(p.grad is None for p in teng.frozen_match.parameters())
    assert not any(k.startswith("NeighConsensus") for k in teng.head.state_dict())
    assert all(torch.equal(v, frozen_before[k]) for k, v in teng.frozen_match.state_dict().items())


# --------------------------------------------------------------------------- #
# the fuse chain and the entry points
# --------------------------------------------------------------------------- #


def _trainer_cfg(config, **opts):
    cfg = merge_cfg_from_list(load_cfg(config), [
        "image_size", str(SIZE), "adapt_iter", "2", "synthetic_data", "True", "epochs", "1",
        "iter_per_epoch", "2", "episode_batch", "2", "test_num", "2", "save_models", "True",
        "workers", "0"])
    for k, v in opts.items():
        cfg[k] = v
    return cfg


@pytest.fixture(scope="module")
def match_ckpt(tmp_path_factory):
    """A ``train_match`` checkpoint of the port (its MatchNet state_dict)."""
    from few_shot_seg_cwt_tpu_torch.train import train_match

    work = tmp_path_factory.mktemp("match")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        for var in SWITCHES:
            mp.delenv(var, raising=False)
        train_match.main(_trainer_cfg(MATCH_CONFIG), device="cpu", log=lambda *_: None)
    paths = sorted(work.rglob("results/match_pascal/**/*.pt"))
    best = [p for p in paths if p.name == "best.pt"]
    return best[0] if best else next(p for p in paths if p.name == "final.pt")


def test_jax_reads_the_port_match_checkpoint_and_gives_the_same_fuse_loss(fuse_setup,
                                                                           match_ckpt,
                                                                           monkeypatch):
    """JAX ``init_frozen_match`` imports the port's ``train_match``
    checkpoint as a reference ``.pth``; the port's reads it the same way;
    the two fuse losses of each episode then agree."""
    for var in SWITCHES:
        monkeypatch.delenv(var, raising=False)
    jeng = fuse_setup["jeng"]
    jcfg = jax_merge(jax_load_cfg(FUSE_CONFIG), OPTS)
    jcfg.matchnet_ckpt = str(match_ckpt)
    frozen = jax_init_frozen_match(jcfg, jeng)
    cfg = merge_cfg_from_list(load_cfg(FUSE_CONFIG), OPTS)
    cfg.matchnet_ckpt = str(match_ckpt)
    teng = _port_engine(fuse_setup, cfg)
    init_frozen_match(cfg, teng, log=lambda *_: None)
    port_frozen = torch.load(str(match_ckpt), weights_only=True)
    assert all(torch.equal(teng.frozen_match.state_dict()[k], v) for k, v in port_frozen.items())
    for i in range(E):
        (value, _), _ = fuse_setup["fn"](jax.tree.map(jnp.asarray, fuse_setup["params"]),
                                         fuse_setup["parts"][i], fuse_setup["eps"][i],
                                         fuse_setup["rngs"][i], frozen)
        one = {k: v[i:i + 1] for k, v in fuse_setup["batch"].items()}
        got = teng.backward_batch(one, w0=torch.from_numpy(fuse_setup["w0"][i:i + 1]),
                                  deterministic=True)
        np.testing.assert_allclose(float(got["loss_mean"]), float(value), rtol=1e-4)


def test_train_fuse_main_resumes_exactly(match_ckpt, tmp_path, monkeypatch):
    """train_fuse over the port's frozen MatchNet: 2 epochs whole, and 1
    epoch cut then resumed by ``auto_resume``, end with the same FuseNet1,
    bit for bit; the frozen MatchNet is in no checkpoint."""
    from few_shot_seg_cwt_tpu_torch.train import train_fuse

    monkeypatch.chdir(tmp_path)
    for var in SWITCHES:
        monkeypatch.delenv(var, raising=False)
    lines = []
    for name, opts in (("whole", {}), ("cut", {"stop_after_epochs": 1}),
                       ("cut", {"auto_resume": True})):
        cfg = _trainer_cfg(FUSE_CONFIG, epochs=2, exp_name=name,
                           matchnet_ckpt=str(match_ckpt), **opts)
        best = train_fuse.main(cfg, device="cpu", log=lines.append)
        assert 0.0 <= best <= 1.0
    assert any(str(l).startswith("=> loaded the frozen MatchNet") for l in lines)
    assert any(str(l).startswith("=> resumed full head train state after epoch 1")
               for l in lines)
    finals = {p.parts[-2]: torch.load(p, weights_only=True)
              for p in tmp_path.rglob("results/fuse_pascal/**/final.pt")}
    assert sorted(finals) == ["cut", "whole"]
    assert sorted(finals["whole"]) == sorted(build_head(cfg, "fuse").state_dict())
    assert all(torch.equal(finals["whole"][k], v) for k, v in finals["cut"].items())


def test_export_serve_fuse_on_the_cpu(tmp_path, monkeypatch):
    """``export_serve --head fuse`` writes an artifact holding the frozen
    MatchNet and FuseNet1; reloaded, it equals eager serve_batch, and so
    does ``tools/serve_loaded`` serving it twice in one process."""
    monkeypatch.setenv("FSS_PIVOT_MXU", "1")
    out = tmp_path / "fuse.pt2"
    info = export_serve.main(["--config", FUSE_CONFIG, "--out", str(out), "--batch", str(E),
                              "--head", "fuse", "--device", "cpu", "--opts", *OPTS])
    assert info["head"] == "fuse" and out.exists()
    assert info["operators"] == ["fss.adapt_binary.default", "fss.pivot_fwd.default"]
    cfg = merge_cfg_from_list(load_cfg(FUSE_CONFIG), OPTS)
    engine = export_serve.load_head_engine(cfg, "fuse", None, "cpu")
    exported = torch.export.load(str(out))
    names = set(exported.state_dict)
    assert {"frozen_match.NeighConsensus.conv.0.conv1.weight", "head.att.0.weight"} <= names
    ep = make_episode_batch(6, E, size=SIZE)
    w0 = engine.init_weights(E, torch.Generator().manual_seed(6))
    inputs = {"s_img": torch.as_tensor(ep["s_img"]),
              "s_label": torch.as_tensor(ep["s_label"]).int(),
              "q_img": torch.as_tensor(ep["q_img"]), "w0": w0}
    with torch.no_grad():
        got = exported.module()(*inputs.values())
    want = engine.serve_batch(ep, w0=w0)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    # tools/serve_loaded: two artifacts (here the same one twice) in one process
    torch.save(inputs, tmp_path / "inputs.pt")
    runs = [str(a) for i in (1, 2) for a in (out, tmp_path / "inputs.pt", tmp_path / f"m{i}.pt")]
    results = serve_loaded.main(runs + ["--device", "cpu", "--reps", "1"])
    assert len(results) == 2 and all(r["episodes_per_s"] > 0 for r in results)
    for i in (1, 2):
        assert torch.equal(torch.load(tmp_path / f"m{i}.pt", weights_only=True), want)


def test_bench_fuse_head_modes_run_on_the_cpu():
    from few_shot_seg_cwt_tpu_torch.tools import bench

    for mode in ("head", "head_eval", "head_serve"):
        out = bench.run(mode, device="cpu", image_size=SIZE, adapt_iter=2, batches=1,
                        episode_batch=2, quiet=1, head="fuse")
        assert out["mode"] == mode and np.isfinite(out["value"]) and out["value"] > 0
        assert out["flops_per_episode"] > 0 and out["kernel_launches"] == {}


@pytest.fixture(scope="module")
def head_steps(tmp_path_factory):
    work = tmp_path_factory.mktemp("head_steps")
    proc = subprocess.run(
        [sys.executable, "-m", "few_shot_seg_cwt_tpu_torch.parallel.dryrun", "--world", "2",
         "--backend", "gloo", "--device", "cpu", "--size", str(SIZE), "--adapt-iter", "3",
         "--checks", "att,asy,fuse", "--out", str(work), "--threads", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:] + proc.stdout[-4000:]
    return {r["check"]: r for r in (json.loads(line) for line in proc.stdout.splitlines()
                                    if line.startswith("{"))}


@pytest.mark.parametrize("head", ["att", "asy", "fuse"])
def test_att_asy_fuse_steps_at_world_2_equal_one_process(head_steps, head):
    """The dryrun's rows: the ranks' step against one process running the
    ranks' slices, within 1e-3 of each gradient tensor's largest entry,
    the parameters equal on both ranks after the step."""
    row = head_steps[f"{head}_step"]
    assert row["ok"], row
    assert row["max_rel_err"] <= 1e-3 and row["world1_max_rel_err"] <= 1e-3
    assert row["grads_live"] and row["params_equal_across_ranks"]
