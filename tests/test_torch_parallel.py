"""The port's data parallelism (``parallel/``) on the CPU: two processes over
gloo against one process and against the JAX package's unsharded steps.

One ``python -m few_shot_seg_cwt_tpu_torch.parallel.dryrun --world 2
--backend gloo --device cpu`` run (33 px, adapt_iter 5; started in the
background while the JAX steps compile, from the port's own module, so no
module of this file is imported in a child; rendezvous through a file
store under ``tmp_path``) runs every step in a reference process (alone,
then in a group of one) and in two ranks on halves of the same global
batch. Weights: the JAX modules' variable trees filled from a numpy seed
(``test_torch_heads._seeded_variables``), carried over by
``utils/convert.py``. Tolerances:

* world 2 against one process, CWT and MMN steps (1- and 3-shot; the
  engines compute in fp32, their features cast to fp32): every gradient
  within 1e-5 of its tensor's largest entry (each rank's backbone runs its
  slice as a batch of its own); the parameters after the step equal on
  both ranks bit for bit;
* world 2 against one process, the stage-1 step in float64 with mixup
  (lambda and the global permutation injected; results kept as float32):
  every parameter and BN statistic within 1e-6 of its tensor's largest
  entry, loss 1e-6 relative, train I/U areas equal;
* world 2 against JAX: the CWT step's gradients rtol 1e-3, atol 1e-3 of
  each tensor's largest entry (``test_torch_train_cwt.py``); the MMN
  step's the same (``test_torch_heads.py``, loss ``wt_ce``); the stage-1
  step's parameters and BN statistics within 1e-4 of each tensor's
  largest entry and its loss 1e-5 relative (``test_torch_pretrain.py``);
* SyncBN (one float64 layer on a batch of 4 split 2 + 2) and the gathered
  eval metrics, ``validate_transformer`` and ``episodic_validate``: the
  dryrun's own checks (1e-12; I/U areas within 0.5% of the pixels, loss
  1e-3 relative; mIoU within 2e-3), every one of which must hold.

In-process: the global-batch draws of the inits and dropout masks, the
rank term of ``batch_generator``, ``local_batch``, the mesh and device
refusals.
"""

import json
import shutil
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
from few_shot_seg_cwt_tpu.episodic.engine import EpisodicEngine as JaxEngine
from few_shot_seg_cwt_tpu.episodic.heads import HeadEngine as JaxHeadEngine
from few_shot_seg_cwt_tpu.models.cwt import MultiHeadAttentionOne as JaxCWT
from few_shot_seg_cwt_tpu.models.pspnet import build_pspnet as jax_build_pspnet
from few_shot_seg_cwt_tpu.models.pspnet import init_classifier_weights as jax_init_w
from few_shot_seg_cwt_tpu.train import pretrain as jax_pretrain
from few_shot_seg_cwt_tpu_torch.config import default_cfg, load_cfg, merge_cfg_from_list
from few_shot_seg_cwt_tpu_torch.data.synthetic import make_episode_batch
from few_shot_seg_cwt_tpu_torch.episodic.engine import EpisodicEngine, pick_w0
from few_shot_seg_cwt_tpu_torch.eval.validate import batch_generator
from few_shot_seg_cwt_tpu_torch.models.cwt import dropout
from few_shot_seg_cwt_tpu_torch.parallel import mesh
from few_shot_seg_cwt_tpu_torch.parallel.dryrun import pretrain_batch
from few_shot_seg_cwt_tpu_torch.train.common import episodic_val_loader, local_batch
from few_shot_seg_cwt_tpu_torch.utils.convert import (cwt_state_dict_from_flax,
                                                      mmn_state_dict_from_flax,
                                                      pspnet_state_dict_from_flax)
from test_torch_heads import _seeded_variables

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SIZE, FEAT, SEED = 33, 5, 7
E_CWT, E_MMN, B_PRE, K_PRE = 4, 2, 4, 2
EP_KEYS = ("s_img", "s_label", "q_img", "q_label", "cls")
COMMON = ["image_size", str(SIZE), "adapt_iter", "5"]
MMN_OPTS = COMMON + ["use_amp", "False", "att_drop", "0.0", "proj_drop", "0.0",
                     "loss_type", "wt_ce"]
PRE_OPTS = ["image_size", str(SIZE), "num_classes_tr", str(K_PRE), "lr", "0.0025",
            "scale_lr", "2.0", "weight_decay", "0.1", "smoothing", "True", "epochs", "1"]
CWT_OPTS = COMMON + ["cls_lr", "0.1"]
CWT_CONFIG = str(REPO / "configs" / "pascal.yaml")
MMN_CONFIG = str(REPO / "configs" / "pascal_mmn.yaml")
PRE_CONFIG = str(REPO / "configs" / "pascal_pretrain.yaml")


def _episodes(seed, e, shot=1):
    return {k: v for k, v in make_episode_batch(seed, e, size=SIZE, shot=shot).items()
            if k in EP_KEYS}


@pytest.fixture(scope="module")
def jax_models():
    """The three JAX models and their seeded variables: the CWT engine, the
    MMN engine (pascal_mmn.yaml, wt_ce, dropout off) and the stage-1 PSPNet
    (2 classes). One backbone's variables serve all three (the three
    configs build the same ResNet-50 PSPNet), so the spec holds them once."""
    # drawn as test_torch_heads.py draws them, whose MMN head is live (a
    # seeded consensus can be dead: every head gradient exactly 0)
    rng = np.random.default_rng(2021)
    x = jnp.zeros((1, SIZE, SIZE, 3))
    mmn_eng = JaxHeadEngine(jax_merge(jax_load_cfg(MMN_CONFIG), MMN_OPTS), "mmn")
    vars_b = _seeded_variables(lambda r, x: mmn_eng.backbone.init({"params": r}, x, train=False),
                               rng, True, x)
    feats = {3: [jnp.zeros((1, FEAT, FEAT, 1024))] * 6,
             4: [jnp.zeros((1, FEAT, FEAT, 2048))] * 3}
    f = jnp.zeros((1, FEAT, FEAT, 512))
    mmn_p = _seeded_variables(mmn_eng.head.init, rng, False, feats, feats, f, f)["params"]
    jcfg = jax_merge(jax_load_cfg(CWT_CONFIG), CWT_OPTS + ["dropout", "0.0"])
    cwt_eng = JaxEngine(jcfg, cwt=JaxCWT(dropout=0.0, attn_dropout=0.0))
    cwt_t = _seeded_variables(cwt_eng.cwt.init, rng, False, jnp.zeros((1, 2, 512)), f, f)

    pcfg = jax_merge(jax_load_cfg(PRE_CONFIG), PRE_OPTS + ["dropout", "0.0", "mixup", "True"])
    pre_model = jax_build_pspnet(pcfg)
    assert (jax.tree.structure(jax.eval_shape(lambda r, x: pre_model.init(
        {"params": r}, x, train=False), jax.random.PRNGKey(0), x))
        == jax.tree.structure(vars_b))
    return {"cwt": (cwt_eng, vars_b, cwt_t), "mmn": (mmn_eng, vars_b, mmn_p),
            "pretrain": (pcfg, pre_model, vars_b)}


@pytest.fixture(scope="module")
def keys():
    """The JAX steps' keys and the classifier inits they draw, which the
    port's ranks get as ``w0`` (each its half)."""
    cwt_rngs = jax.random.split(jax.random.PRNGKey(7), E_CWT)
    mmn_rngs = jax.random.split(jax.random.PRNGKey(5), E_MMN)
    cwt_w0 = np.stack([np.array(jax_init_w(jax.random.split(r, 3)[1], 2, 512))
                       for r in cwt_rngs])
    mmn_w0 = np.stack([np.array(jax_init_w(jax.random.split(r)[0], 2, 512)) for r in mmn_rngs])
    with jax.enable_x64(True):
        # the pretrain step's mixup draws, as it draws them under x64
        _, rng_mix, rng_perm = jax.random.split(jax.random.PRNGKey(12), 3)
        lam = float(jax.random.beta(rng_mix, 0.2, 0.2))
        perm = np.asarray(jax.random.permutation(rng_perm, B_PRE))
    return {"cwt": (cwt_rngs, cwt_w0), "mmn": (mmn_rngs, mmn_w0), "mix": (lam, perm)}


@pytest.fixture(scope="module")
def ddp(jax_models, keys, tmp_path_factory):
    """The dryrun process and its work directory (started in the
    background; the JAX fixtures run meanwhile)."""
    work = tmp_path_factory.mktemp("dryrun")
    _, vars_b, cwt_t = jax_models["cwt"]
    _, _, mmn_p = jax_models["mmn"]
    backbone = pspnet_state_dict_from_flax(vars_b)
    lam, perm = keys["mix"]
    spec = {
        "seed": SEED, "checks": ["cwt", "mmn", "pretrain", "eval", "validate", "collectives"],
        "cwt": {"config": CWT_CONFIG, "opts": CWT_OPTS, "episodes": E_CWT,
                "weights": {"backbone": backbone, "cwt": cwt_state_dict_from_flax(cwt_t)},
                "w0": torch.from_numpy(keys["cwt"][1])},
        "mmn": {"config": MMN_CONFIG, "opts": MMN_OPTS, "episodes": E_MMN, "shots": [1, 3],
                "weights": {"backbone": backbone, "head": mmn_state_dict_from_flax(mmn_p)},
                "w0": {1: torch.from_numpy(keys["mmn"][1])}},
        "pretrain": {"config": PRE_CONFIG, "opts": PRE_OPTS, "batch": B_PRE,
                     "dtype": "float64", "mixup": True, "weights": backbone, "lam": lam,
                     "perm": torch.from_numpy(perm.copy())},
        "eval": {"config": CWT_CONFIG, "opts": CWT_OPTS, "episodes": 4},
        "validate": {"config": CWT_CONFIG, "opts": CWT_OPTS, "episodes": 4, "test_num": 8},
    }
    torch.save(spec, work / "spec.in.pt")
    proc = subprocess.Popen(
        [sys.executable, "-m", "few_shot_seg_cwt_tpu_torch.parallel.dryrun", "--world", "2",
         "--backend", "gloo", "--device", "cpu", "--spec", str(work / "spec.in.pt"),
         "--out", str(work), "--threads", "1"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, work
    if proc.poll() is None:   # a failed fixture left it running
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ddp_results(ddp, jax_cwt_grads, jax_mmn_grads, jax_pretrain_step):
    """The dryrun's rows and results, read once the JAX steps (computed
    while it runs) are done."""
    proc, work = ddp
    out, err = proc.communicate(timeout=600)
    assert proc.returncode in (0, 3), err[-4000:]   # 3: a check failed, held below
    rows = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    load = lambda name: torch.load(work / name, weights_only=False)  # noqa: E731
    ref = load("reference_0.pt")
    out = {"rows": rows, "plain": ref["plain"], "world1": ref["world1"],
           "ranks": [load(f"rank_{r}.pt")["rank"] for r in range(2)]}
    shutil.rmtree(work)   # ~1 GB of spec and results, read now
    return out


@pytest.fixture(scope="module")
def jax_cwt_grads(jax_models, keys, ddp):
    """The JAX CWT step's gradient of the mean episode loss (dropout off)."""
    import functools

    eng, vars_b, vars_t = jax_models["cwt"]
    batch = {k: jnp.asarray(v) for k, v in _episodes(SEED, E_CWT).items()}
    rngs = keys["cwt"][0]

    def mean_loss(params):
        losses, _ = jax.vmap(functools.partial(eng.train_episode_loss, with_metrics=True),
                             in_axes=(None, None, None, 0, 0))(params, {}, vars_b, batch, rngs)
        return jnp.mean(losses)

    grads = jax.jit(jax.grad(mean_loss))(vars_t["params"])
    return cwt_state_dict_from_flax({"params": jax.tree.map(np.asarray, grads)})


@pytest.fixture(scope="module")
def jax_mmn_grads(jax_models, keys, ddp):
    """The JAX MMN train step's gradient of the mean of the two 1-shot
    episodes' losses (dropout off)."""
    eng, vars_b, params = jax_models["mmn"]
    batch = _episodes(SEED + 1, E_MMN)
    rngs = keys["mmn"][0]
    grad = jax.jit(lambda p, ep, r: jax.grad(
        lambda q: eng.train_episode_loss(q, vars_b, ep, r)[0])(p))
    per = [grad(params, {k: jnp.asarray(v[i]) for k, v in batch.items()}, rngs[i])
           for i in range(E_MMN)]
    mean = jax.tree.map(lambda *g: np.mean(np.stack([np.asarray(x) for x in g]), 0), *per)
    return mmn_state_dict_from_flax(mean)


@pytest.fixture(scope="module")
def jax_pretrain_step(jax_models, ddp):
    """The JAX stage-1 step in float64 with mixup on the dryrun's batch."""
    pcfg, model, variables = jax_models["pretrain"]
    img, gt = pretrain_batch({"batch": B_PRE}, SEED, SIZE, K_PRE)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), variables)
        opt = jax_pretrain.param_group_optimizer(pcfg, v64["params"], 4)
        step = jax_pretrain.make_pretrain_step(model, opt, pcfg)
        params, stats, _, m = step(v64["params"], v64["batch_stats"], opt.init(v64["params"]),
                                   jnp.asarray(img, jnp.float64), jnp.asarray(gt),
                                   jax.random.PRNGKey(12))
        final = jax.tree.map(np.asarray, {"params": params, "batch_stats": stats})
    return float(m["loss"]), pspnet_state_dict_from_flax(final)


# --------------------------------------------------------------------------- #
# world 2 against one process
# --------------------------------------------------------------------------- #


def _row(results, check, **match):
    rows = [r for r in results["rows"] if r["check"] == check
            and all(r.get(k) == v for k, v in match.items())]
    assert len(rows) == 1, (check, match, results["rows"])
    return rows[0]


def _close(got, want, frac, err_msg=""):
    for k, w in want.items():
        w = w.double().numpy()
        np.testing.assert_allclose(got[k].double().numpy(), w, rtol=0,
                                   atol=frac * float(np.abs(w).max()), err_msg=f"{err_msg} {k}")


@pytest.mark.parametrize("tile", [1, 2])
def test_cwt_step_at_world_2_equals_one_process(ddp_results, tile):
    row = _row(ddp_results, "cwt_step", tile=tile)
    assert row["ok"] and row["params_equal_across_ranks"] and row["grads_live"], row
    rec = lambda d: d["cwt"][f"tile{tile}"]  # noqa: E731
    _close(rec(ddp_results["ranks"][0])["grads"], rec(ddp_results["plain"])["grads"], 1e-5)
    digests = [rec(r)["digests"] for r in ddp_results["ranks"]]
    assert digests[0] == digests[1] and len(digests[0]) == 5


@pytest.mark.parametrize("shot", [1, 3])
def test_mmn_step_at_world_2_equals_one_process(ddp_results, shot):
    row = _row(ddp_results, "mmn_step", shot=shot, head="fp32_head")
    assert row["ok"] and row["params_equal_across_ranks"] and row["grads_live"], row
    rec = lambda d: d["mmn"][shot]["fp32_head"]  # noqa: E731
    _close(rec(ddp_results["ranks"][0])["grads"], rec(ddp_results["plain"])["grads"], 1e-5)
    _close(rec(ddp_results["world1"])["grads"], rec(ddp_results["plain"])["grads"], 1e-5)


def test_pretrain_step_at_world_2_equals_one_process_in_float64(ddp_results):
    row = _row(ddp_results, "pretrain_step")
    assert row["ok"] and row["params_equal_across_ranks"], row
    got, want = (d["pretrain"]["step"] for d in (ddp_results["ranks"][0],
                                                 ddp_results["plain"]))
    _close(got["params"], want["params"], 1e-6, "param")
    _close(got["buffers"], want["buffers"], 1e-6, "buffer")
    np.testing.assert_allclose(float(got["metrics"]["loss"]), float(want["metrics"]["loss"]),
                               rtol=1e-6)
    for k in ("inter", "union", "target"):
        np.testing.assert_array_equal(got["metrics"][k].numpy(), want["metrics"][k].numpy())


@pytest.mark.parametrize("check", ["collectives", "eval_gathered", "validate"])
def test_gathers_syncbn_and_validation_at_world_2(ddp_results, check):
    row = _row(ddp_results, check)
    assert row["ok"], row
    if check == "collectives":
        assert row["to_host_rank_order"] and max(row["syncbn_max_rel_err"].values()) <= 1e-12
    if check == "validate":
        assert row["ranks_agree"] and 0.0 < row["miou"] <= 1.0


# --------------------------------------------------------------------------- #
# world 2 against the JAX package's unsharded steps
# --------------------------------------------------------------------------- #


def test_cwt_step_at_world_2_matches_jax(ddp_results, jax_cwt_grads):
    got = ddp_results["ranks"][0]["cwt"]["tile1"]["grads"]
    assert sorted(got) == sorted(jax_cwt_grads)
    top = max(float(w.abs().max()) for w in jax_cwt_grads.values())
    for name, w in jax_cwt_grads.items():
        if name == "layer_norm.bias":   # no gradient under the K=2 loss
            assert float(got[name].abs().max()) <= 1e-6 * top
            continue
        w = w.numpy()
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(w).max()), err_msg=name)


def test_mmn_step_at_world_2_matches_jax(ddp_results, jax_mmn_grads):
    got = ddp_results["ranks"][0]["mmn"][1]["fp32_head"]["grads"]
    assert sorted(got) == sorted(jax_mmn_grads)
    for name, w in jax_mmn_grads.items():
        w = w.numpy()
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(w).max()), err_msg=name)


def test_pretrain_step_at_world_2_matches_jax(ddp_results, jax_pretrain_step):
    loss, want = jax_pretrain_step
    got = ddp_results["ranks"][0]["pretrain"]["step"]
    np.testing.assert_allclose(float(got["metrics"]["loss"]), loss, rtol=1e-5)
    state = {**got["params"], **got["buffers"]}
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        w = w.numpy()
        np.testing.assert_allclose(state[name].double().numpy(), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()) + 1e-12, err_msg=name)


# --------------------------------------------------------------------------- #
# in one process
# --------------------------------------------------------------------------- #


def test_train_inits_and_masks_are_the_global_batch_rows():
    """Rank r of 2 keeps rows r * E .. of the global batch's inits and
    dropout masks, drawn from the same generator state as one process."""
    cfg = default_cfg()
    cfg.image_size, cfg.adapt_iter = SIZE, 2
    engine = EpisodicEngine(cfg, device="cpu")
    whole = pick_w0(engine, 6, torch.Generator().manual_seed(3), None)
    halves = [pick_w0(engine, 3, torch.Generator().manual_seed(3), None, (r, 2)) for r in (0, 1)]
    torch.testing.assert_close(torch.cat(halves), whole, rtol=0, atol=0)
    x = torch.ones(6, 2, 4, 5)
    whole = dropout(x, 0.5, torch.Generator().manual_seed(4), (6, 2, 1, 5))
    halves = [dropout(x[3 * r:3 * r + 3], 0.5, torch.Generator().manual_seed(4), (3, 2, 1, 5),
                      shard=(r, 2)) for r in (0, 1)]
    torch.testing.assert_close(torch.cat(halves), whole, rtol=0, atol=0)


def test_batch_generator_rank_0_seeds_as_before():
    for seed, run, b in ((0, 0, 0), (42, 1, 3), (7, 4, 11)):
        old = torch.Generator().manual_seed(seed + (run * 1_000_003 + b) * 65_537)
        assert torch.equal(batch_generator(seed, run, b).get_state(), old.get_state())
        assert torch.equal(batch_generator(seed, run, b, rank=0).get_state(), old.get_state())
        ranked = torch.Generator().manual_seed(seed + (run * 1_000_003 + b) * 65_537 + 1)
        assert torch.equal(batch_generator(seed, run, b, rank=1).get_state(), ranked.get_state())


def test_without_a_group_every_collective_is_the_identity():
    assert mesh.rank_world() == (0, 1) and not mesh.active() and mesh.is_main_process()
    t = torch.arange(6.0).reshape(3, 2)
    p = torch.nn.Parameter(torch.ones(2))
    p.grad = torch.full((2,), 3.0)
    assert mesh.all_reduce_grads([p]) == 0 and torch.equal(p.grad, torch.full((2,), 3.0))
    np.testing.assert_array_equal(mesh.to_host({"t": t})["t"], t.numpy())
    assert mesh.to_host({"s": torch.tensor(2.0)})["s"] == 2.0
    assert mesh.gather_rows(t) is t and mesh.all_reduce_sum(t) is t
    assert mesh.distributed_init(None, device="cpu") == torch.device("cpu")


def test_batch_and_mesh_refusals(monkeypatch):
    assert local_batch(8, 2) == 4 and local_batch(8) == 8
    with pytest.raises(ValueError, match="global batch 5 must divide over 2 processes"):
        local_batch(5, 2)
    cfg = default_cfg()
    cfg.mesh_shape = [4]
    with pytest.raises(ValueError, match=r"mesh_shape \[4\].*must be \[2\]"):
        mesh.check_mesh(cfg, 2)
    mesh.check_mesh(merge_cfg_from_list(default_cfg(), ["mesh_shape", "[2]"]), 2)
    cfg.mesh_shape, cfg.mesh_axes = None, ["data", "model"]
    with pytest.raises(ValueError, match="mesh_axes"):
        mesh.check_mesh(cfg, 2)
    # WORLD_SIZE says 2: the mesh is checked before any group is joined, and
    # a rank without its card raises instead of running elsewhere
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    cfg.mesh_axes = ["data"]
    cfg.mesh_shape = [3]
    with pytest.raises(ValueError, match="mesh_shape"):
        mesh.distributed_init(cfg, device="cpu")
    cfg.mesh_shape = None
    with pytest.raises(RuntimeError, match="no CUDA device|needs cuda:1"):
        mesh.distributed_init(cfg, device="cuda")
    assert not mesh.active()
    # a config meant for several processes without WORLD_SIZE does not run on one
    monkeypatch.delenv("WORLD_SIZE")
    cfg.distributed = True
    with pytest.raises(ValueError, match="WORLD_SIZE is not"):
        mesh.distributed_init(cfg, device="cpu")


def test_replay_refuses_several_processes(tmp_path):
    cfg = load_cfg(str(REPO / "configs" / "pascal.yaml"))
    cfg.replay = str(tmp_path / "episodes.jsonl")
    with pytest.raises(ValueError, match="single-process"):
        episodic_val_loader(cfg, device="cpu", rank=1, world=2)
