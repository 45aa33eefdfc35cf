"""The port's stage-1 pretraining entry point on the CPU (33 px, synthetic
records, batch 8): one epoch with standard and one with episodic
validation, checkpoints that stage 2 reads, an exact resume, a mixed
``bf16_stages`` policy, and what the trainer refuses. The step and the
validations are held against the JAX package in
``tests/test_torch_pretrain.py``; the step's loss and weight gradients
under the mixed policy are held here (float64 on both sides, as there:
the stage inputs are rounded to bf16 alike, and the losses within 1e-6
relative, every gradient within 5e-3 of its tensor's largest entry).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from few_shot_seg_cwt_tpu.models.pspnet import build_pspnet as jax_build_pspnet
from few_shot_seg_cwt_tpu.ops.losses import smoothed_cross_entropy as jax_smoothed_ce
from few_shot_seg_cwt_tpu_torch.config import load_cfg, merge_cfg_from_list
from few_shot_seg_cwt_tpu_torch.models.pspnet import (build_pspnet, stage_boundary_casts,
                                                      stage_dtype_policy)
from few_shot_seg_cwt_tpu_torch.ops.losses import smoothed_cross_entropy
from few_shot_seg_cwt_tpu_torch.train import pretrain
from few_shot_seg_cwt_tpu_torch.train import test as test_entry
from few_shot_seg_cwt_tpu_torch.train.common import load_backbone_weights, stage1_weights_path
from few_shot_seg_cwt_tpu_torch.utils.ckpt import load_ckpt
from few_shot_seg_cwt_tpu_torch.utils.convert import pspnet_state_dict_from_flax
from few_shot_seg_cwt_tpu_torch.utils.tb import read_scalars
from test_torch_pretrain import K, SIZE, _batch, _cfgs, _perturb

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(**over):
    opts = {"synthetic_data": True, "image_size": 33, "batch_size": 8, "epochs": 1,
            "num_classes_tr": 4, "workers": 0, "adapt_iter": 2, "episode_batch": 2,
            "test_num": 4, "n_runs": 1, "log_freq": 4, "mixup": True}
    opts.update(over)
    flat = []
    for k, v in opts.items():
        flat += [k, str(v)]
    return merge_cfg_from_list(load_cfg(os.path.join(REPO, "configs/pascal_pretrain.yaml")),
                               flat)


@pytest.mark.parametrize("episodic_val", [False, True])
def test_main_one_epoch_writes_stage1_weights(tmp_path, monkeypatch, episodic_val):
    """One epoch; ``best.ckpt`` overlays a fresh PSPNet as a reference
    ``.pth`` does, and ``train.test`` loads it from the stage-1 schema."""
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(episodic_val=episodic_val)
    lines = []
    best = pretrain.main(cfg, device="cpu", log=lambda l: lines.append(str(l)))
    assert np.isfinite(best) and 0.0 < best <= 1.0
    assert any(l.startswith("===== Epoch 0") for l in lines)
    want = "episodic_validate run 0" if episodic_val else "Testing results"
    assert any(l.startswith(want) for l in lines)
    sv = pretrain.save_dir(cfg)
    assert sorted(os.listdir(sv)) == ["best.ckpt", "final.ckpt", "log.txt", "model",
                                      "train_state.ckpt"]
    with open(os.path.join(sv, "log.txt")) as f:
        logged = f.read().splitlines()
    assert logged and logged == lines[len(lines) - len(logged):]
    assert any(l.startswith(want) for l in logged)
    assert {"train_loss", "mean_iou/val"} <= set(read_scalars(os.path.join(sv, "model")))
    fresh = build_pspnet(cfg)
    load_backbone_weights(fresh, os.path.join(sv, "best.ckpt"), skip_gamma=True)
    sd = load_ckpt(os.path.join(sv, "best.ckpt"))
    assert torch.equal(fresh.state_dict()["layer4.2.bn3.running_var"],
                       sd["layer4.2.bn3.running_var"])

    tcfg = _cfg(resume_weights=str(tmp_path / "weights"), test_num=2, episode_batch=2)
    path = stage1_weights_path(tcfg)
    os.makedirs(os.path.dirname(path))
    os.replace(os.path.join(sv, "best.ckpt"), path)
    lines = []
    test_entry.main(tcfg, device="cpu", log=lambda l: lines.append(str(l)))
    assert f"=> loaded weight '{path}'" in lines


def test_resume_equals_an_uninterrupted_run(tmp_path, monkeypatch):
    """Two epochs straight against one epoch, a stop and a resume from
    ``train_state.ckpt`` (``stop_after_epochs``; ``epochs`` stays 2 so the
    schedule is the same): the final weights and BN statistics are equal.
    VGG keeps it short."""
    monkeypatch.chdir(tmp_path)

    def run(exp, **over):
        cfg = _cfg(arch="vgg", epochs=2, exp_name=exp, **over)
        pretrain.main(cfg, device="cpu", log=lambda l: None)
        return pretrain.save_dir(cfg)

    straight = load_ckpt(os.path.join(run("a"), "final.ckpt"))
    sv = run("b", stop_after_epochs=1)
    state = load_ckpt(os.path.join(sv, "train_state.ckpt"))
    assert state["meta"]["epoch"] == 1 and "scheduler" in state
    lines = []
    cfg = _cfg(arch="vgg", epochs=2, exp_name="b", auto_resume=True)
    pretrain.main(cfg, device="cpu", log=lambda l: lines.append(str(l)))
    assert any("resumed full pretrain state at epoch 1" in l for l in lines)
    resumed = load_ckpt(os.path.join(sv, "final.ckpt"))
    assert sorted(resumed) == sorted(straight)
    for k, v in straight.items():
        torch.testing.assert_close(resumed[k], v, rtol=1e-6, atol=1e-7, msg=k)


def test_uniform_bf16_trains_fp32_and_validates_a_cast_copy(tmp_path, monkeypatch):
    """``compute_dtype bfloat16``: the backbone trains in fp32 (the JAX step
    casts nothing) and episodic validation runs a bf16 copy."""
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(arch="vgg", compute_dtype="bfloat16", episodic_val=True)
    best = pretrain.main(cfg, device="cpu", log=lambda l: None)
    assert np.isfinite(best)
    sd = load_ckpt(os.path.join(pretrain.save_dir(cfg), "final.ckpt"))
    assert {v.dtype for v in sd.values() if v.is_floating_point()} == {torch.float32}


@pytest.mark.parametrize("over,match", [
    # several processes are ported: without torchrun's WORLD_SIZE a
    # multi_host config raises rather than train on one process
    ({"multi_host": True}, "WORLD_SIZE is not"),
])
def test_main_refuses_what_is_not_ported(over, match, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match=match):
        pretrain.main(_cfg(**over), device="cpu", log=lambda l: None)


@pytest.mark.parametrize("episodic_val", [False, True])
def test_main_trains_under_a_mixed_stage_policy(tmp_path, monkeypatch, episodic_val):
    """``bf16_stages stem,layer1,layer2``: the parameters train in fp32 (the
    JAX model's stage-boundary casts round activations only) and episodic
    validation runs a copy with those stages' parameters cast, leaving the
    trained model as it was."""
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(bf16_stages="stem,layer1,layer2", episodic_val=episodic_val)
    best = pretrain.main(cfg, device="cpu", log=lambda l: None)
    assert np.isfinite(best)
    sd = load_ckpt(os.path.join(pretrain.save_dir(cfg), "final.ckpt"))
    assert {v.dtype for v in sd.values() if v.is_floating_point()} == {torch.float32}


def test_main_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain.main(_cfg(), log=lambda l: None)


def test_mixed_policy_step_gradients_match_jax():
    """Stage 1 under ``bf16_stages stem,layer1`` (ResNet-50, a batch of 3 at
    33 px, label smoothing): the train-mode loss and every weight gradient
    of the port's model against the JAX model's, whose ``build_pspnet``
    installs the stage-boundary casts; both in float64, the stem's and
    layer1's inputs rounded to bf16 on both sides. Every gradient within
    5e-3 of its tensor's largest entry: past layer1 they agree to 2e-5, the
    stem's, which cross layer1's bf16 boundary on their way back, to 2e-3
    (XLA may drop a rounding there: ``xla_allow_excess_precision``). The
    casts must matter: the fp32-policy gradients lie further from JAX's
    than the limit (1.9 of the scale: a train-mode step at 33 px is
    ill-conditioned)."""
    jcfg, tcfg = _cfgs(arch="resnet", bf16_stages="stem,layer1")
    model = jax_build_pspnet(jcfg)
    assert model.stage_dtypes is not None
    variables = jax.jit(lambda r, x: model.init({"params": r}, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    variables = _perturb(jax.tree.map(lambda x: np.array(x, np.float32), variables),
                         np.random.default_rng(2021))
    img, gt = _batch(1)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), variables)

        def loss_fn(params):
            logits, _ = model.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                    jnp.asarray(img, jnp.float64), train=True,
                                    mutable=["batch_stats"])
            return jax_smoothed_ce(logits, jnp.asarray(gt), K, 0.1)

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(v64["params"])
        want = pspnet_state_dict_from_flax(jax.tree.map(
            np.asarray, {"params": grads, "batch_stats": v64["batch_stats"]}))

    def port_grads(policy_cfg):
        fp32_cfg = tcfg.clone()
        fp32_cfg.bf16_stages = None
        net = stage_boundary_casts(build_pspnet(fp32_cfg), stage_dtype_policy(policy_cfg))
        net.load_state_dict(pspnet_state_dict_from_flax(variables))
        net.double().train()
        out = smoothed_cross_entropy(net(torch.from_numpy(img).double()),
                                     torch.from_numpy(gt), K, 0.1)
        out.backward()
        return float(out.detach()), {k: p.grad for k, p in net.named_parameters()
                                     if p.grad is not None}

    got_loss, got = port_grads(tcfg)
    np.testing.assert_allclose(got_loss, float(loss), rtol=1e-6)
    plain = tcfg.clone()
    plain.bf16_stages = None
    _, fp32_grads = port_grads(plain)
    worst, worst_fp32 = 0.0, 0.0
    for name, g in got.items():
        w = want[name].numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, name
        worst = max(worst, float(np.abs(g.numpy() - w).max()) / scale)
        worst_fp32 = max(worst_fp32, float(np.abs(fp32_grads[name].numpy() - w).max()) / scale)
    print(f"mixed policy: worst gradient {worst:.3e} of its scale; fp32 policy {worst_fp32:.3e}")
    assert worst < 5e-3 < worst_fp32, (worst, worst_fp32)
