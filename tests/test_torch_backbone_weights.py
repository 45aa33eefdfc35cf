"""The port's entry points against the reference's stage-1 weight handling
and its fp32 parity, on the CPU (33 px images, synthetic episodes).

* fp32 parity: ``train.test.main``, ``train.train_cwt.main`` and
  ``train.train_head.main`` leave both TF32 flags off, whatever they were.
* Stage-1 weights: a port PSPNet ``state_dict`` (every BN field perturbed by
  seeded numpy noise, ``gamma`` 0.7 instead of its init 0.2) saved under the
  reference's schema ``<resume_weights>/<train_name>/split=<s>/
  pspnet_<arch><layers>/best.pth`` is what each entry point's backbone holds,
  but for ``classifier.*`` and ``gamma`` (the stage-2 filter). ``test.main``
  given the file itself keeps ``gamma``. ``wt_file 1`` reads ``best1.pth``; a
  missing file logs ``=> no weight found at``.
* The JAX package's ``init_backbone`` on the same directory gives the same
  backbone, carried over by ``utils/convert.py``. Weights compare exactly:
  they are copied, not computed.
"""

import os

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)

from few_shot_seg_cwt_tpu.config import default_cfg as jax_default_cfg
from few_shot_seg_cwt_tpu.episodic.engine import EpisodicEngine as JaxEngine
from few_shot_seg_cwt_tpu.train.common import init_backbone as jax_init_backbone
from few_shot_seg_cwt_tpu_torch.config import default_cfg, load_cfg, merge_cfg_from_list
from few_shot_seg_cwt_tpu_torch.models.pspnet import build_pspnet
from few_shot_seg_cwt_tpu_torch.train import common
from few_shot_seg_cwt_tpu_torch.train import test as test_entry
from few_shot_seg_cwt_tpu_torch.train import train_cwt, train_head
from few_shot_seg_cwt_tpu_torch.utils.convert import pspnet_state_dict_from_flax

torch.set_num_threads(1)

SIZE = 33
CONFIG_MMN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs", "pascal_mmn.yaml")
FILTERED = ("classifier.", "gamma")


def _stage1_state(seed):
    """A port PSPNet state_dict unlike the seeded init: BN fields and the
    classifier perturbed, gamma 0.7."""
    rng = np.random.default_rng(seed)
    sd = build_pspnet(default_cfg()).state_dict()
    for k, v in sd.items():
        if k.endswith(("running_mean", "bias")) or k.startswith("classifier."):
            sd[k] = v + torch.from_numpy(rng.normal(0, 0.1, v.shape).astype(np.float32))
        elif k.endswith(("running_var", "weight")) and v.ndim == 1:
            sd[k] = v * torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
    sd["gamma"] = torch.tensor(0.7)
    return sd


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """resume_weights root with best.pth and best1.pth under the schema."""
    root = tmp_path_factory.mktemp("pretrained_models")
    leaf_dir = root / "pascal" / "split=0" / "pspnet_resnet50"
    leaf_dir.mkdir(parents=True)
    states = {}
    for leaf, seed in (("best.pth", 1), ("best1.pth", 2)):
        states[leaf] = _stage1_state(seed)
        torch.save(states[leaf], leaf_dir / leaf)
    return root, leaf_dir, states


def _small(cfg, root, tmp):
    cfg.image_size, cfg.adapt_iter = SIZE, 2
    cfg.synthetic_data, cfg.epochs, cfg.iter_per_epoch, cfg.episode_batch = True, 1, 2, 2
    cfg.test_num, cfg.n_runs, cfg.save_models = 2, 1, False
    cfg.model_dir, cfg.resume_weights = str(tmp / "model_ckpt"), str(root)
    return cfg


def _run(entry, root, tmp):
    """Run one entry point with both TF32 flags on beforehand; returns its
    backbone, its log lines and the flags afterwards."""
    got, lines = {}, []

    def record_init(cfg, generator=None, log=print):
        got["backbone"] = common.init_backbone(cfg, generator, log)
        return got["backbone"]

    def record_eval(cfg, engine, log=print):
        test_entry_load(cfg, engine, log)
        got["backbone"] = engine.backbone

    test_entry_load = test_entry.load_eval_weights
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        if entry == "train_cwt":
            mp.setattr(train_cwt, "init_backbone", record_init)
            train_cwt.main(_small(default_cfg(), root, tmp), device="cpu", log=lines.append)
        elif entry == "train_head":
            mp.setattr(train_head, "init_backbone", record_init)
            cfg = merge_cfg_from_list(load_cfg(CONFIG_MMN), ["use_amp", "False"])
            train_head.main(_small(cfg, root, tmp), "mmn", device="cpu", log=lines.append)
        else:
            mp.setattr(test_entry, "load_eval_weights", record_eval)
            cfg = _small(default_cfg(), root, tmp)
            if entry == "test_file":
                cfg.resume_weights = str(root / "pascal" / "split=0" / "pspnet_resnet50" /
                                         "best.pth")
            test_entry.main(cfg, device="cpu", log=lines.append)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    return got["backbone"], [str(line) for line in lines], flags


@pytest.fixture(scope="module")
def runs(stage1, tmp_path_factory):
    root = stage1[0]
    return {entry: _run(entry, root, tmp_path_factory.mktemp(entry))
            for entry in ("train_cwt", "train_head", "test", "test_file")}


def _assert_backbone(backbone, saved, keep_gamma=False):
    got = backbone.state_dict()
    assert sorted(got) == sorted(saved)
    for k, v in got.items():
        if k.startswith("classifier.") or (k == "gamma" and not keep_gamma):
            assert not torch.equal(v.cpu(), saved[k]), k   # the seeded init's
        else:
            assert torch.equal(v.cpu(), saved[k]), k
    if not keep_gamma:
        assert float(backbone.gamma.detach()) == pytest.approx(0.2)


@pytest.mark.parametrize("entry", ["train_cwt", "train_head", "test"])
def test_entry_points_turn_tf32_off(runs, entry):
    assert runs[entry][2] == (False, False)


@pytest.mark.parametrize("entry", ["train_cwt", "train_head", "test"])
def test_entry_points_load_stage1_weights_by_the_schema(runs, stage1, entry):
    _, leaf_dir, states = stage1
    backbone, lines, _ = runs[entry]
    path = str(leaf_dir / "best.pth")
    assert f"=> loading weight '{path}'" in lines
    assert f"=> loaded weight '{path}'" in lines
    _assert_backbone(backbone, states["best.pth"])


def test_test_main_file_route_keeps_gamma(runs, stage1):
    _, leaf_dir, states = stage1
    backbone, lines, flags = runs["test_file"]
    assert f"=> loaded weight '{leaf_dir / 'best.pth'}'" in lines
    assert float(backbone.gamma.detach()) == pytest.approx(0.7)
    _assert_backbone(backbone, states["best.pth"], keep_gamma=True)
    assert flags == (False, False)


def test_wt_file_1_picks_best1(stage1):
    root, leaf_dir, states = stage1
    cfg = _small(default_cfg(), root, root)
    cfg.wt_file = 1
    lines = []
    backbone = common.init_backbone(cfg, log=lines.append)
    assert common.stage1_weights_path(cfg) == str(leaf_dir / "best1.pth")
    assert lines[-1] == f"=> loaded weight '{leaf_dir / 'best1.pth'}'"
    _assert_backbone(backbone, states["best1.pth"])


@pytest.mark.parametrize("where", ["init_backbone", "test.load_eval_weights"])
def test_a_missing_file_logs_no_weight_found(tmp_path, where):
    cfg = _small(default_cfg(), tmp_path / "empty", tmp_path)
    cfg.ckpt_used = None
    want = f"=> no weight found at '{common.stage1_weights_path(cfg)}'"
    lines = []
    if where == "init_backbone":
        backbone = common.init_backbone(cfg, log=lines.append)
    else:
        backbone = build_pspnet(cfg)
        engine = type("E", (), {"backbone": backbone})()
        test_entry.load_eval_weights(cfg, engine, log=lines.append)
    assert want in lines
    init = build_pspnet(default_cfg()).state_dict()
    assert all(torch.equal(v, init[k]) for k, v in backbone.state_dict().items())


def test_jax_init_backbone_gives_the_same_backbone(stage1, capsys):
    root, leaf_dir, states = stage1
    jcfg = jax_default_cfg()
    jcfg.image_size, jcfg.resume_weights = SIZE, str(root)
    variables = jax_init_backbone(jcfg, JaxEngine(jcfg))
    assert f"=> loaded weight '{leaf_dir / 'best.pth'}'" in capsys.readouterr().out
    from_jax = pspnet_state_dict_from_flax(variables)
    port = common.init_backbone(_small(default_cfg(), root, root), log=lambda *_: None)
    got = port.state_dict()
    assert sorted(from_jax) == sorted(got)
    for k, v in got.items():
        if k.startswith("classifier."):
            continue                                    # each package's own init
        assert torch.equal(from_jax[k], v), k
        if not k.startswith(FILTERED) and not k.endswith("num_batches_tracked"):
            assert torch.equal(v, states["best.pth"][k]), k
