"""The port's stage-1 pretraining entry point on the CPU (33 px, synthetic
records, batch 8): one epoch with standard and one with episodic
validation, checkpoints that stage 2 reads, an exact resume, and what the
trainer refuses. The step and the validations are held against the JAX
package in ``tests/test_torch_pretrain.py``.
"""

import os

import numpy as np
import pytest
import torch

from few_shot_seg_cwt_tpu_torch.config import load_cfg, merge_cfg_from_list
from few_shot_seg_cwt_tpu_torch.models.pspnet import build_pspnet
from few_shot_seg_cwt_tpu_torch.train import pretrain
from few_shot_seg_cwt_tpu_torch.train import test as test_entry
from few_shot_seg_cwt_tpu_torch.train.common import load_backbone_weights, stage1_weights_path
from few_shot_seg_cwt_tpu_torch.utils.ckpt import load_ckpt
from few_shot_seg_cwt_tpu_torch.utils.tb import read_scalars

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
    ({"bf16_stages": "stem,layer1"}, "mixed stage policy"),
    # several processes are ported: without torchrun's WORLD_SIZE a
    # multi_host config raises rather than train on one process
    ({"multi_host": True}, "WORLD_SIZE is not"),
])
def test_main_refuses_what_is_not_ported(over, match, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    error = NotImplementedError if "bf16_stages" in over else ValueError
    with pytest.raises(error, match=match):
        pretrain.main(_cfg(**over), device="cpu", log=lambda l: None)


def test_main_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain.main(_cfg(), log=lambda l: None)
