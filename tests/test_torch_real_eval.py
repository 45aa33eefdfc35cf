"""The real-data entry points of the port on a small dataset tree (written
by ``tests/test_torch_data.py:write_tree``, 33 px, adapt_iter 5):

* ``train.test.main`` on the tree against the JAX engine on the same
  episodes (the JAX package's sampler under the same seeds), the same weights
  (the JAX init with perturbed norms, handed to ``main`` as ``.pth`` files)
  and the same classifier inits (``eval.validate.batch_generator``). The
  tolerance is ``tests/test_torch_engine.py``'s: per episode, at most 0.5% of
  the query's pixels may flip, so a class's summed I and U may each differ by
  at most that many pixels, and its IoU by the bound that follows;
* ``validate_transformer`` in replay mode: run r scores log episodes
  r * test_num onward (one stream across runs), and an ``episode_batch``
  that does not divide ``test_num`` is refused; without replay every run
  starts at episode 0;
* ``train.test.main`` on a replayed log, ``train_cwt.main`` and
  ``train_head.main`` (``configs/pascal_mmn.yaml`` as shipped) a step each on
  the tree.
"""

import json
import os
import random
import re
from collections import defaultdict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from few_shot_seg_cwt_tpu.data.episodic import EpisodicDataset as JaxEpisodicDataset
from few_shot_seg_cwt_tpu.episodic.engine import EpisodicEngine as JaxEngine
from few_shot_seg_cwt_tpu_torch.config import load_cfg, merge_cfg_from_list
from few_shot_seg_cwt_tpu_torch.data.loader import EpisodeLoader
from few_shot_seg_cwt_tpu_torch.episodic.engine import init_weights
from few_shot_seg_cwt_tpu_torch.eval.validate import batch_generator, validate_transformer
from few_shot_seg_cwt_tpu_torch.models.cwt import build_cwt
from few_shot_seg_cwt_tpu_torch.models.pspnet import build_pspnet
from few_shot_seg_cwt_tpu_torch.train.common import episodic_val_loader, trans_ckpt_dir
from few_shot_seg_cwt_tpu_torch.utils.convert import (cwt_state_dict_from_flax,
                                                      pspnet_state_dict_from_flax)
from tests.test_torch_data import tree_cfgs, write_tree
from tests.test_torch_engine import _perturb_norms

torch.set_num_threads(1)

SIZE, FEAT, E = 33, 5, 2


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    write_tree(root)
    return root


def _class_lines(lines):
    """Per run, {class: IoU} from the entry point's log (each run's "Class"
    lines follow its "mIoU---Val result" line)."""
    runs = []
    for line in map(str, lines):
        if line.startswith("mIoU---Val result"):
            runs.append({})
        m = re.match(r"Class (\d+) : ([0-9.]+)", line)
        if m:
            runs[-1][int(m.group(1))] = float(m.group(2))
    return runs


def test_test_main_on_the_tree_matches_the_jax_engine(tree, tmp_path):
    jcfg, tcfg = tree_cfgs(tree, image_size=SIZE, opts=[
        ("adapt_iter", 5), ("cls_lr", 0.1), ("test_num", 4), ("n_runs", 2),
        ("episode_batch", E)])
    jeng = JaxEngine(jcfg)
    rng = np.random.default_rng(2021)
    vars_b = jax.jit(lambda r, x: jeng.backbone.init({"params": r}, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    vars_b = _perturb_norms(jax.tree.map(lambda x: np.array(x, np.float32), vars_b), rng)
    f = jnp.zeros((1, FEAT, FEAT, 512))
    vars_t = jax.jit(lambda r: jeng.cwt.init(r, jnp.zeros((1, 2, 512)), f, f))(
        jax.random.PRNGKey(1))
    vars_t = _perturb_norms(jax.tree.map(lambda x: np.array(x, np.float32), vars_t), rng)

    # the same weights for the port's entry point, as reference .pth files
    backbone = build_pspnet(tcfg)
    backbone.load_state_dict(pspnet_state_dict_from_flax(vars_b))
    torch.save(backbone.state_dict(), tmp_path / "pspnet.pth")
    cwt = build_cwt(tcfg)
    cwt.load_state_dict(cwt_state_dict_from_flax(vars_t))
    tcfg.update(resume_weights=str(tmp_path / "pspnet.pth"), model_dir=str(tmp_path / "m"),
                ckpt_used="best")
    out = trans_ckpt_dir(tcfg)
    os.makedirs(out)
    torch.save(cwt.state_dict(), os.path.join(out, "best.pth"))

    from few_shot_seg_cwt_tpu_torch.train import test as entry

    lines = []
    miou = entry.main(tcfg, device="cpu", log=lines.append)
    assert any("loading transformer weight" in str(l) for l in lines)
    port_runs = _class_lines(lines)

    # the JAX side: the same seeds, the same sequential episodes per run (a
    # fresh stream each run), the inits validate_transformer draws
    seed = int(jcfg.manual_seed)
    random.seed(seed)
    np.random.seed(seed)
    ds = JaxEpisodicDataset(jcfg, train=False)
    eval_w0 = jax.jit(jeng.eval_episode_from_w0)
    pixels = SIZE * SIZE
    run_mious, run_bounds = [], []
    for run in range(2):
        inter, union, count = defaultdict(float), defaultdict(float), defaultdict(int)
        for b in range(2):
            w0 = init_weights(E, batch_generator(seed, run, b), 2, 512, "cpu").numpy()
            for i in range(E):
                ep = ds[b * E + i]
                jep = {k: jnp.asarray(ep[k]) for k in ("s_img", "s_label", "q_img",
                                                       "q_label", "cls")}
                pred = eval_w0(vars_b, vars_t, jep, jnp.asarray(w0[i]))["pred_q"]
                it, un, _ = jeng._upsampled_metrics(pred, jep["q_label"])
                c = int(ep["cls"])
                inter[c] += float(it[1])
                union[c] += float(un[1])
                count[c] += 1
        iou = {c: inter[c] / (union[c] + 1e-10) for c in union}
        assert set(port_runs[run]) == set(iou), (run, port_runs[run], iou)
        bounds = {}
        for c in iou:
            flips = 0.005 * pixels * count[c]
            bounds[c] = flips * (1 + iou[c]) / max(union[c] - flips, 1.0)
            # the log rounds to 4 decimals
            assert abs(port_runs[run][c] - iou[c]) <= bounds[c] + 5e-5, (
                run, c, port_runs[run][c], iou[c], bounds[c])
        run_mious.append(float(np.mean(list(iou.values()))))
        run_bounds.append(float(np.mean(list(bounds.values()))))
    assert abs(miou - np.mean(run_mious)) <= np.mean(run_bounds) + 1e-6


class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.int32(i), "cls": np.int32(1 + i % 3)}


class _Recorder:
    """An engine that records which episodes each call scores."""

    def __init__(self):
        self.seen = []

    def eval_metrics_batch(self, batch, generator):
        self.seen.append(batch["i"].tolist())
        e = len(batch["i"])
        ones = torch.ones(e, 2)
        return {"cls": batch["cls"], "inter": ones, "union": 2 * ones, "inter0": ones,
                "union0": 2 * ones, "loss": torch.zeros(e)}


@pytest.mark.parametrize("replaying", [True, False])
def test_validate_replay_walks_one_stream_across_runs(tree, replaying):
    _, cfg = tree_cfgs(tree, opts=[("test_num", 4), ("n_runs", 3),
                                   ("replay", "episodes.jsonl" if replaying else None)])
    engine = _Recorder()
    loader = EpisodeLoader(_Indexed(10), batch_size=2, shuffle=False, num_workers=2,
                           device="cpu")
    validate_transformer(cfg, engine, loader, log=lambda *a: None)
    runs = [sum(engine.seen[2 * r:2 * r + 2], []) for r in range(3)]
    if replaying:  # run r starts at episode r * test_num (wrapping at 10)
        assert runs == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 0, 1]]
    else:
        assert runs == [[0, 1, 2, 3]] * 3
    cfg.test_num = 5
    if replaying:
        with pytest.raises(ValueError, match="must divide test_num 5"):
            validate_transformer(cfg, engine, loader, log=lambda *a: None)
        # several processes would score the rank padding's repeats twice
        with pytest.raises(ValueError, match="single-process"):
            episodic_val_loader(cfg, device="cpu", rank=0, world=2)


def _pair(j):
    return [f"JPEGImages/{j:03d}.{'jpg' if j % 2 == 0 else 'png'}",
            f"SegmentationClassAug/{j:03d}.png"]


def test_test_main_replays_a_log_across_runs(tree, tmp_path):
    """Log episodes 0-1 are of class 1 and 2-3 of class 2: run 1 must score
    class 1 alone and run 2 class 2 alone."""
    log = tmp_path / "episodes.jsonl"
    eps = [(0, 1, [2]), (4, 1, [6]), (1, 2, [3]), (5, 2, [7])]
    log.write_text("".join(json.dumps({"q": _pair(q), "cls": c, "s": [_pair(s) for s in sup]})
                           + "\n" for q, c, sup in eps))
    _, cfg = tree_cfgs(tree, image_size=SIZE, opts=[
        ("adapt_iter", 2), ("test_num", 2), ("n_runs", 2), ("episode_batch", 2),
        ("replay", str(log)), ("workers", 2)])
    from few_shot_seg_cwt_tpu_torch.train import test as entry

    lines = []
    miou = entry.main(cfg, device="cpu", log=lines.append)
    runs = _class_lines(lines)
    assert [sorted(r) for r in runs] == [[1], [2]]
    assert 0.0 <= miou <= 1.0


def test_train_cwt_main_takes_a_step_on_the_tree(tree, tmp_path):
    from few_shot_seg_cwt_tpu_torch.train import train_cwt

    _, cfg = tree_cfgs(tree, image_size=SIZE, opts=[
        ("adapt_iter", 2), ("epochs", 1), ("iter_per_epoch", 2), ("episode_batch", 2),
        ("test_num", 2), ("n_runs", 1), ("save_models", False), ("workers", 2)])
    lines = []
    best = train_cwt.main(cfg, device="cpu", log=lines.append)
    assert 0.0 <= best <= 1.0
    assert any(str(l).startswith("Epoch 1:") for l in lines)


def test_train_head_main_takes_a_step_on_the_tree(tree, monkeypatch, tmp_path):
    """configs/pascal_mmn.yaml as shipped (use_amp, hor_flip + resize_np)."""
    from few_shot_seg_cwt_tpu_torch.train import train_head

    monkeypatch.chdir(tmp_path)
    config = Path(__file__).resolve().parents[1] / "configs" / "pascal_mmn.yaml"
    cfg = merge_cfg_from_list(load_cfg(str(config)), [
        "data_root", str(tree), "train_list", str(tree / "all.txt"),
        "val_list", str(tree / "all.txt"), "image_size", str(SIZE), "adapt_iter", "2",
        "epochs", "1", "iter_per_epoch", "2", "episode_batch", "2", "test_num", "2",
        "workers", "2"])
    cfg.scan_cache = None
    assert cfg.use_amp and cfg.augmentations == ["hor_flip", "resize_np"]
    lines = []
    best = train_head.main(cfg, "mmn", device="cpu", log=lines.append)
    assert 0.0 <= best <= 1.0
    assert any(str(l).startswith("val: mIoU") for l in lines)
