"""The port's CCA trainers and the episode-statistics tool on the CPU
(configs/pascal_cca.yaml at 33 px, synthetic episodes, 2 inner steps):
``train_cca`` keeps the stage-1 classifier and writes its checkpoints,
``train_cca1`` (the adaptive host pass) resumes exactly, and
``train_count``'s per-class ratios equal the JAX tool's on the same
synthetic stream.
"""

import os
from pathlib import Path

import numpy as np
import torch

from few_shot_seg_cwt_tpu.config import load_cfg as jax_load_cfg
from few_shot_seg_cwt_tpu.config import merge_cfg_from_list as jax_merge
from few_shot_seg_cwt_tpu.train import train_count as jax_train_count
from few_shot_seg_cwt_tpu_torch.config import load_cfg, merge_cfg_from_list
from few_shot_seg_cwt_tpu_torch.models.pspnet import build_pspnet
from few_shot_seg_cwt_tpu_torch.train import train_cca, train_cca1, train_count
from few_shot_seg_cwt_tpu_torch.train.common import init_backbone, stage1_weights_path

torch.set_num_threads(1)

CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "pascal_cca.yaml")
SWITCHES = ("FSS_PIVOT_MXU", "FSS_PIVOT_PALLAS", "FSS_DISABLE_PALLAS", "FSS_NCONS_R4",
            "FSS_NCONS_INT8")
OPTS = ["image_size", "33", "adapt_iter", "2", "synthetic_data", "True", "epochs", "1",
        "iter_per_epoch", "4", "episode_batch", "2", "test_num", "2", "save_models", "True",
        "workers", "0"]


def _cfg(**opts):
    cfg = merge_cfg_from_list(load_cfg(CONFIG), OPTS)
    for k, v in opts.items():
        cfg[k] = v
    return cfg


def _stage1(tmp_path, cfg):
    """A stage-1 checkpoint in the reference's schema whose classifier
    differs from the seeded init's."""
    model = build_pspnet(cfg, torch.Generator().manual_seed(99))
    path = stage1_weights_path(cfg)
    os.makedirs(os.path.dirname(path))
    torch.save(model.state_dict(), path)
    return model


def test_train_cca_keeps_the_stage1_classifier_and_saves(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for var in SWITCHES:
        monkeypatch.delenv(var, raising=False)
    cfg = _cfg(resume_weights=str(tmp_path / "weights"))
    stage1 = _stage1(tmp_path, cfg)
    kept = init_backbone(cfg, log=lambda *_: None, skip_classifier=False)
    dropped = init_backbone(cfg, log=lambda *_: None)
    assert torch.equal(kept.classifier.weight, stage1.classifier.weight)
    assert not torch.equal(dropped.classifier.weight, stage1.classifier.weight)
    assert torch.equal(dropped.layer1[0].conv1.weight, stage1.layer1[0].conv1.weight)
    lines = []
    best = train_cca.main(cfg, device="cpu", log=lambda l: lines.append(str(l)))
    assert 0.0 <= best <= 1.0
    assert f"=> loaded weight '{stage1_weights_path(cfg)}'" in lines
    assert any(l.startswith("val: mIoU") for l in lines)
    sv = train_cca.results_dir(cfg, adaptive=False)
    assert sv.startswith("./results/cca_pascal/")
    assert {"train_state.pt", "log.txt"} <= set(os.listdir(sv))
    state = torch.load(os.path.join(sv, "train_state.pt"), weights_only=False)
    assert state["meta"]["epoch"] == 1 and "scheduler" in state
    assert "corr_net.NeighConsensus.conv.0.conv1.weight" in state["model"]


def test_train_cca1_resumes_exactly(tmp_path, monkeypatch):
    """Two epochs whole against one epoch cut and resumed by
    ``auto_resume``: the same head, bit for bit (the per-epoch relabel
    stream, the step generators and the dropout state carry over)."""
    monkeypatch.chdir(tmp_path)
    for var in SWITCHES:
        monkeypatch.delenv(var, raising=False)
    lines = []
    for name, opts in (("whole", {}), ("cut", {"stop_after_epochs": 1}),
                       ("cut", {"auto_resume": True})):
        cfg = _cfg(epochs=2, exp_name=name, **opts)
        best = train_cca1.main(cfg, device="cpu", log=lambda l: lines.append(str(l)))
        assert 0.0 <= best <= 1.0
    assert any(l.startswith("=> resumed full cca1 train state after epoch 1") for l in lines)
    states = {p.parts[-2]: torch.load(p, weights_only=False)
              for p in tmp_path.rglob("results/cca1_pascal/**/train_state.pt")}
    assert sorted(states) == ["cut", "whole"]
    assert states["whole"]["meta"] == states["cut"]["meta"]
    for k, v in states["whole"]["model"].items():
        assert torch.equal(states["cut"]["model"][k], v), k


def test_train_count_equals_jax(capsys):
    opts = ["image_size", "33", "synthetic_data", "True", "test_num", "12"]
    want = jax_train_count.main(jax_merge(jax_load_cfg(CONFIG), opts))
    lines = []
    got = train_count.main(merge_cfg_from_list(load_cfg(CONFIG), opts), log=lines.append)
    assert got == want and len(got) > 1
    assert lines[0] == "class ratios over 12 episodes:"
    assert all(0.0 < v < 1.0 for v in got.values())
    assert np.isclose(sum(float(l.split("n=")[1].rstrip(")")) for l in lines[1:]), 12)
