"""The port's tools and utils (ROADMAP item 14) against the JAX package's,
on the CPU: the log summarizer, the visualizer, the IoU trackers, the
checkpoint converter, the ``log.txt`` tee and the TensorBoard scalars,
``preflight`` on a tree that ``tests/test_torch_data.py:write_tree``
writes, ``bench_loader``'s line, the ``profile_dir`` trace, the episode
recorder's log and the parity drill's chaining, and a serve artifact run by
a process that imports only torch and the port's ``ops``.

Everything is held equal to the JAX package's output on the same inputs,
except where the two packages differ by design: ``to-port`` writes the
port's checkpoint format where ``to-flax`` writes orbax (compared through
``utils/convert.py``), and the recorder and the drill need the reference
tree, whose tests skip without it (as ``tests/test_replay.py`` and
``tests/test_parity_drill.py`` do); their parts that do not need it run
here.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from few_shot_seg_cwt_tpu.utils import extra_metrics as jax_metrics
from few_shot_seg_cwt_tpu.utils import logging as jax_logging
from few_shot_seg_cwt_tpu.utils import print_log as jax_print_log
from few_shot_seg_cwt_tpu.utils import visualize as jax_visualize
from few_shot_seg_cwt_tpu_torch.config import default_cfg, load_cfg, merge_cfg_from_list
from few_shot_seg_cwt_tpu_torch.utils import extra_metrics, print_log, visualize
from few_shot_seg_cwt_tpu_torch.utils import logging as port_logging
from tests.ref_compat import HAVE_REF
from tests.test_torch_data import write_tree

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    write_tree(root)
    return root


# --------------------------------------------------------------------------- #
# print_log, visualize, extra_metrics
# --------------------------------------------------------------------------- #


def test_print_log_scrape_and_summarize_equal_jax(tmp_path, capsys):
    a, b, c = tmp_path / "a.txt", tmp_path / "b.txt", tmp_path / "c.txt"
    a.write_text("noise\nmIoU---Val result: mIoU 0.4510.\nstuff\n"
                 "mIoU---Val result: mIoU 0.5630.\n")
    b.write_text("Test: [8/16] mIoU 0.9\nmIoU---Val result: mIoU 0.3125.\n")
    c.write_text("no eval here\n")
    paths = [str(a), str(b), str(c)]
    for p in paths:
        assert print_log.scrape(p) == jax_print_log.scrape(p)
    got = print_log.summarize(paths)
    got_out = capsys.readouterr().out
    want = jax_print_log.summarize(paths)
    assert got == want and got_out == capsys.readouterr().out
    assert got == {str(a): 0.563, str(b): 0.3125}


def test_visualizer_equals_jax(tmp_path):
    rng = np.random.default_rng(6)
    mask = rng.integers(0, 30, (9, 11))
    mask[0, :4] = 255
    np.testing.assert_array_equal(visualize.decode_seg_map(mask),
                                  jax_visualize.decode_seg_map(mask))
    s_imgs = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    s_labels = rng.integers(0, 2, (2, 16, 16)).astype(np.int32)
    s_labels[0, :3] = 255
    q_img = rng.standard_normal((16, 16, 3)).astype(np.float32)
    q_label = rng.integers(0, 2, (16, 16)).astype(np.int32)
    pred = rng.integers(0, 2, (16, 16)).astype(np.int32)
    got = visualize.Masker(alpha=0.3).episode_composite(s_imgs, s_labels, q_img, q_label, pred)
    want = jax_visualize.Masker(alpha=0.3).episode_composite(s_imgs, s_labels, q_img, q_label,
                                                             pred)
    assert got.shape == (16, 64, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(visualize.Masker().overlay(q_img, q_label),
                                  jax_visualize.Masker().overlay(q_img, q_label))
    out = tmp_path / "vis" / "ep.png"
    visualize.Masker().save(got, str(out))
    import cv2

    np.testing.assert_array_equal(cv2.imread(str(out))[..., ::-1], got)


def test_iou_trackers_equal_jax():
    rng = np.random.default_rng(7)
    port_b, jax_b = extra_metrics.BinaryIoU(), jax_metrics.BinaryIoU()
    port_f, jax_f = extra_metrics.FullIoU(4), jax_metrics.FullIoU(4)
    for _ in range(3):
        pred = rng.integers(0, 4, (20, 20))
        target = rng.integers(0, 4, (20, 20))
        target[0, :6] = 255
        port_b.update(pred % 2, target % 2 + 254 * (target == 255))
        jax_b.update(pred % 2, target % 2 + 254 * (target == 255))
        port_f.update(pred, target)
        jax_f.update(pred, target)
    np.testing.assert_array_equal(port_b.iou, jax_b.iou)
    assert port_b.miou == jax_b.miou
    np.testing.assert_array_equal(port_f.confusion, jax_f.confusion)
    np.testing.assert_array_equal(port_f.iou, jax_f.iou)
    assert (port_f.miou, port_f.pixel_accuracy) == (jax_f.miou, jax_f.pixel_accuracy)


# --------------------------------------------------------------------------- #
# convert_ckpt
# --------------------------------------------------------------------------- #


def _reference_pth(path, kind, arch="resnet"):
    """A reference-format .pth (DDP prefix, {"state_dict"}) of a seeded port
    module; returns its state_dict."""
    from few_shot_seg_cwt_tpu_torch.models.cwt import build_cwt
    from few_shot_seg_cwt_tpu_torch.models.pspnet import build_pspnet

    cfg = default_cfg()
    cfg.arch, cfg.num_classes_tr = arch, 16
    model = build_cwt(cfg) if kind == "cwt" else build_pspnet(cfg, torch.Generator().manual_seed(4))
    sd = {k: v + 0.01 * torch.randn(v.shape, generator=torch.Generator().manual_seed(i))
          if v.is_floating_point() else v for i, (k, v) in enumerate(model.state_dict().items())}
    torch.save({"epoch": 3, "state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    return sd


def test_strip_module_equals_jax(tmp_path):
    from few_shot_seg_cwt_tpu.utils.convert_ckpt import main as jax_main
    from few_shot_seg_cwt_tpu_torch.utils.convert_ckpt import main

    src = tmp_path / "in.pth"
    sd = _reference_pth(src, "cwt")
    main(["strip-module", str(src), str(tmp_path / "port.pth")])
    jax_main(["strip-module", str(src), str(tmp_path / "jax.pth")])
    got = torch.load(tmp_path / "port.pth", weights_only=True)["state_dict"]
    want = torch.load(tmp_path / "jax.pth", weights_only=False)["state_dict"]
    assert list(got) == list(want) == list(sd)
    for k in sd:
        assert torch.equal(got[k], want[k]) and torch.equal(got[k], sd[k])


@pytest.mark.parametrize("kind,arch", [("pspnet", "resnet"), ("pspnet", "vgg"), ("cwt", "resnet")])
def test_to_port_equals_jax_to_flax(tmp_path, kind, arch):
    """``to-port`` writes the port's state_dict; JAX's ``to-flax`` of the same
    file, carried back by ``utils/convert.py``, gives the same tensors."""
    from few_shot_seg_cwt_tpu.utils.ckpt import load_ckpt as jax_load_ckpt
    from few_shot_seg_cwt_tpu.utils.convert_ckpt import main as jax_main
    from few_shot_seg_cwt_tpu_torch.utils.ckpt import load_ckpt
    from few_shot_seg_cwt_tpu_torch.utils.convert import (cwt_state_dict_from_flax,
                                                          pspnet_state_dict_from_flax)
    from few_shot_seg_cwt_tpu_torch.utils.convert_ckpt import main

    src = tmp_path / "ref.pth"
    sd = _reference_pth(src, kind, arch)
    main(["to-port", kind, str(src), str(tmp_path / "port.pth"), "--arch", arch])
    jax_main(["to-flax", kind, str(src), str(tmp_path / "flax.ckpt"), "--arch", arch])
    got = load_ckpt(str(tmp_path / "port.pth"))
    tree = jax.tree.map(np.asarray, jax_load_ckpt(str(tmp_path / "flax.ckpt")))
    want = (cwt_state_dict_from_flax(tree) if kind == "cwt"
            else pspnet_state_dict_from_flax(tree))
    assert got.keys() == sd.keys() == want.keys()
    for k in sd:
        assert torch.equal(got[k], sd[k]), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_to_port_refuses_a_file_that_does_not_fit(tmp_path):
    from few_shot_seg_cwt_tpu_torch.utils.convert_ckpt import main

    src = tmp_path / "bad.pth"
    sd = _reference_pth(src, "cwt")
    sd.pop("fc.bias")
    torch.save(sd, src)
    with pytest.raises(RuntimeError, match="fc.bias"):
        main(["to-port", "cwt", str(src), str(tmp_path / "out.pth")])


# --------------------------------------------------------------------------- #
# the log.txt tee and the TensorBoard scalars
# --------------------------------------------------------------------------- #


def test_log_tee_equals_jax(tmp_path, monkeypatch, capsys):
    lines = ["==> Start training", {"a": 1}, "mIoU---Val result: mIoU 0.5000."]
    for mod, d in ((port_logging, tmp_path / "port"), (jax_logging, tmp_path / "jax")):
        mod.log_to(str(d))
        log = mod.get_logger()
        for line in lines:
            log(line)
        log("extra", filename="other.txt")
        mod.log_to(None)
        log("not teed")
    out = capsys.readouterr().out.splitlines()
    assert out[:len(out) // 2] == out[len(out) // 2:]
    for name in ("log.txt", "other.txt"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    monkeypatch.setenv("RANK", "1")
    port_logging.log_to(str(tmp_path / "rank1"))
    port_logging.get_logger()("rank 1 writes nothing")
    port_logging.log_to(None)
    assert capsys.readouterr().out == "" and not (tmp_path / "rank1" / "log.txt").exists()


def _tiny_head_cfg(path, tmp_path, **over):
    opts = {"synthetic_data": True, "image_size": 33, "adapt_iter": 2, "epochs": 1,
            "iter_per_epoch": 2, "episode_batch": 1, "test_num": 2, "workers": 0,
            "use_amp": False, "exp_name": "tee", "save_models": False}
    opts.update(over)
    flat = [x for k, v in opts.items() for x in (k, str(v))]
    return merge_cfg_from_list(load_cfg(str(REPO / path)), flat)


@pytest.mark.parametrize("trainer", ["train_head", "train_match"])
def test_head_trainers_tee_log_txt(trainer, tmp_path, monkeypatch):
    """Every line of the run from the results directory on goes to its
    ``log.txt``, the validation line among them, with ``save_models`` off."""
    import importlib

    from few_shot_seg_cwt_tpu_torch.train.train_head import results_dir

    monkeypatch.chdir(tmp_path)
    path = "configs/pascal_mmn.yaml" if trainer == "train_head" else "configs/pascal_match.yaml"
    cfg = _tiny_head_cfg(path, tmp_path)
    lines = []
    importlib.import_module(f"few_shot_seg_cwt_tpu_torch.train.{trainer}").main(
        cfg, device="cpu", log=lambda l: lines.append(str(l)))
    head = "mmn" if trainer == "train_head" else "match"
    logged = (tmp_path / results_dir(cfg, head) / "log.txt").read_text().splitlines()
    assert logged == lines[len(lines) - len(logged):]
    assert logged[0] == f"==> Start training head '{head}'"
    assert any(line.startswith("val: mIoU") for line in logged)


def _hide(monkeypatch, *modules):
    for m in modules:
        monkeypatch.setitem(sys.modules, m, None)
        for k in [k for k in sys.modules if k.startswith(m + ".")]:
            monkeypatch.setitem(sys.modules, k, None)


def test_scalars_jsonl_equals_jax(tmp_path, monkeypatch):
    from few_shot_seg_cwt_tpu.utils.tb import SummaryWriter as JaxWriter
    from few_shot_seg_cwt_tpu_torch.utils.tb import SummaryWriter, read_scalars

    _hide(monkeypatch, "tensorboard", "tensorflow")
    for cls, d in ((SummaryWriter, tmp_path / "port"), (JaxWriter, tmp_path / "jax")):
        w = cls(str(d))
        for step, (loss, miou) in enumerate([(1.5, 0.25), (np.float32(0.75), 0.5)]):
            w.add_scalar("train_loss", loss, step)
            w.add_scalar("mean_iou/val", miou, np.int64(step))
        w.flush()
        w.close()
    port = (tmp_path / "port" / "scalars.jsonl").read_text()
    assert port == (tmp_path / "jax" / "scalars.jsonl").read_text()
    assert read_scalars(str(tmp_path / "port")) == {
        "train_loss": [(0, 1.5), (1, 0.75)], "mean_iou/val": [(0, 0.25), (1, 0.5)]}


def test_events_file_reads_back(tmp_path, monkeypatch):
    from few_shot_seg_cwt_tpu_torch.utils.tb import SummaryWriter, read_scalars

    _hide(monkeypatch, "tensorflow")   # tensorboard's own reader, not TensorFlow's

    w = SummaryWriter(str(tmp_path))
    for step in range(3):
        w.add_scalar("train_loss", 1.0 / (step + 1), step)
        w.add_scalar("mean_iou/val", 0.125 * step, step)
    w.close()
    assert not (tmp_path / "scalars.jsonl").exists()
    got = read_scalars(str(tmp_path))
    assert [s for s, _ in got["train_loss"]] == [0, 1, 2]
    np.testing.assert_allclose([v for _, v in got["train_loss"]], [1.0, 0.5, 1 / 3], rtol=1e-6)
    assert got["mean_iou/val"] == [(0, 0.0), (1, 0.125), (2, 0.25)]


# --------------------------------------------------------------------------- #
# preflight, bench_loader, the profiler trace
# --------------------------------------------------------------------------- #


def _preflight_assets(tree, tmp_path):
    """A stage-1 .pth and a CWT .pth (the port's seeded init, reference
    format), and the --opts that name them and the tree."""
    from few_shot_seg_cwt_tpu_torch.train.common import trans_ckpt_dir

    stage1 = tmp_path / "stage1.pth"
    _reference_pth(stage1, "pspnet")
    opts = ["data_root", str(tree), "train_list", str(tree / "all.txt"), "val_list",
            str(tree / "png.txt"), "resume_weights", str(stage1), "model_dir",
            str(tmp_path / "model"), "ckpt_used", "best", "image_size", "33"]
    cfg = merge_cfg_from_list(load_cfg(str(REPO / "configs/pascal.yaml")), opts)
    trans = Path(trans_ckpt_dir(cfg)) / "best.pth"
    trans.parent.mkdir(parents=True)
    _reference_pth(trans, "cwt")
    return stage1, opts


@pytest.mark.parametrize("stage1_present", [True, False])
def test_preflight_on_a_tree(tree, tmp_path, capsys, stage1_present):
    from few_shot_seg_cwt_tpu_torch.tools import preflight

    stage1, opts = _preflight_assets(tree, tmp_path)
    if not stage1_present:
        stage1.unlink()
    rc = preflight.main(["--config", str(REPO / "configs/pascal.yaml"), "--opts", *opts])
    out = capsys.readouterr().out
    if stage1_present:
        assert rc == 0, out
        assert "FAIL" not in out and "READY. Parity commands:" in out
        for what in ("data_root", "train_list", "val_list", "data_root coherence",
                     "stage-1 .pth", "weight coverage", "CWT weights"):
            assert f"  PASS  {what}" in out, what
        assert "  SKIP  replay log" in out
        assert "few_shot_seg_cwt_tpu_torch.train.test" in out
    else:
        assert rc == 1
        assert f"  FAIL  stage-1 weights — no .pth at {stage1}" in out
        assert "NOT READY — 1 issue(s):" in out


def test_bench_loader_keys_equal_jax(tmp_path, capsys):
    from few_shot_seg_cwt_tpu.tools.bench_loader import main as jax_main
    from few_shot_seg_cwt_tpu_torch.tools.bench_loader import main

    args = ["--episodes", "4", "--batch", "2", "--workers", "2", "--image-size", "33",
            "--images", "4"]
    got = main(args + ["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = jax_main(args)
    assert line == got and set(got) == set(want)
    assert got["episodes"] == want["episodes"] == 4 and got["value"] > 0


def test_profile_dir_writes_a_trace(tmp_path):
    from few_shot_seg_cwt_tpu_torch.episodic.engine import EpisodicEngine
    from few_shot_seg_cwt_tpu_torch.eval.validate import validate_transformer
    from few_shot_seg_cwt_tpu_torch.train.common import episodic_val_loader

    cfg = default_cfg()
    cfg.image_size, cfg.adapt_iter, cfg.synthetic_data = 33, 2, True
    cfg.test_num, cfg.n_runs, cfg.episode_batch = 2, 1, 2
    cfg.profile_dir = str(tmp_path / "profile")
    lines = []
    validate_transformer(cfg, EpisodicEngine(cfg, device="cpu"),
                         episodic_val_loader(cfg, device="cpu"), log=lines.append)
    (trace,) = (tmp_path / "profile").glob("validate_transformer.*.trace.json")
    assert f"=> profile trace written to {trace}" in lines
    names = {ev.get("name") for ev in json.loads(trace.read_text())["traceEvents"]}
    assert "fss::adapt_binary" in names


# --------------------------------------------------------------------------- #
# record_episodes and parity_drill
# --------------------------------------------------------------------------- #


def _episodes(tree, n=4):
    """Episodes in the recorder's schema over the tree's images (even lines
    of ``all.txt`` hold class 1, odd lines class 2), paths relative to the
    root."""
    pairs = [line.split() for line in (tree / "all.txt").read_text().splitlines()]
    out = []
    for e in range(n):
        cls = 1 + e % 2
        group = pairs[cls - 1::2]
        out.append({"q": group[e // 2], "cls": cls, "s": [group[e // 2 + 1]]})
    return out


def test_recorder_log_is_what_replay_reads(tree, tmp_path):
    from few_shot_seg_cwt_tpu.data.replay import ReplayEpisodicDataset as JaxReplay
    from few_shot_seg_cwt_tpu.config import default_cfg as jax_default_cfg
    from few_shot_seg_cwt_tpu_torch.data.replay import ReplayEpisodicDataset, load_episode_log
    from few_shot_seg_cwt_tpu_torch.tools.record_episodes import write_log

    eps = _episodes(tree)
    path = tmp_path / "episodes.jsonl"
    write_log(str(path), eps)
    assert load_episode_log(str(path)) == eps
    assert [json.loads(line) for line in path.read_text().splitlines()] == eps
    cfgs = []
    for cfg in (jax_default_cfg(), default_cfg()):
        cfg.data_root, cfg.image_size, cfg.train_split = str(tree), 33, 0
        cfgs.append(cfg)
    got, want = ReplayEpisodicDataset(cfgs[1], str(path)), JaxReplay(cfgs[0], str(path))
    assert len(got) == len(want) == len(eps)
    for i in range(len(eps)):
        a, b = got[i], want[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.skipif(not HAVE_REF, reason="reference tree not mounted")
def test_recorder_walks_the_reference_sampler(tree, tmp_path):
    from few_shot_seg_cwt_tpu.config import default_cfg as jax_default_cfg
    from few_shot_seg_cwt_tpu.tools.record_episodes import record as jax_record
    from few_shot_seg_cwt_tpu_torch.tools.record_episodes import record
    from tests.ref_compat import REF

    cfgs = []
    for cfg in (jax_default_cfg(), default_cfg()):
        cfg.data_root, cfg.val_list, cfg.train_split = str(tree), str(tree / "all.txt"), 0
        cfg.image_size, cfg.manual_seed, cfg.workers = 33, 5, 0
        cfgs.append(cfg)
    assert record(cfgs[1], REF, 6) == jax_record(cfgs[0], REF, 6)


def _drill_yaml(tree, tmp_path):
    path = tmp_path / "drill.yaml"
    path.write_text(f"""
DATA:
  data_root: {tree}
  train_list: {tree / 'all.txt'}
  val_list: {tree / 'png.txt'}
  train_name: pascal
  train_split: 0
  workers: 0
EVAL:
  image_size: 33
  adapt_iter: 2
  test_num: 4
  n_runs: 1
  episode_batch: 2
""")
    return path


def test_parity_drill_chains_its_stages(tree, tmp_path, monkeypatch, capsys):
    """preflight -> record (stubbed: the reference tree is not here) ->
    ``train.test`` on the log -> ``ab_dtype`` on the same log and .pth,
    through the port's entry points on the CPU, and the final summary."""
    from few_shot_seg_cwt_tpu_torch.tools import parity_drill, record_episodes

    stage1, opts = _preflight_assets(tree, tmp_path)
    calls = []

    def recorder(argv):
        calls.append(argv)
        out = argv[argv.index("--out") + 1]
        record_episodes.write_log(out, _episodes(tree))
        return out

    monkeypatch.setattr(record_episodes, "main", recorder)
    config = _drill_yaml(tree, tmp_path)
    opts = [o for o in opts if o not in ("image_size", "33")]
    summary = parity_drill.main(["--config", str(config), "--reference", "unused",
                                 "--workdir", str(tmp_path / "drill"), "--device", "cpu",
                                 "--opts", *opts])
    out = capsys.readouterr().out
    assert calls and calls[0][calls[0].index("--reference") + 1] == "unused"
    assert summary["ok"] and summary["preflight"] == "ready"
    assert summary["episode_log"] == str(tmp_path / "drill" / "episodes.jsonl")
    assert 0.0 <= summary["replay_miou"] <= 1.0
    assert {"miou_fp32", "miou_bf16"} <= set(summary["ab"])
    for stage in range(1, 5):
        assert f"== drill stage {stage}/4" in out
    assert json.loads(out.strip().splitlines()[-1])["ok"] is True


def test_parity_drill_stops_at_preflight(tree, tmp_path, capsys):
    from few_shot_seg_cwt_tpu_torch.tools import parity_drill

    with pytest.raises(SystemExit):
        parity_drill.main(["--config", str(_drill_yaml(tree, tmp_path)), "--reference",
                           "unused", "--workdir", str(tmp_path / "drill"), "--device", "cpu",
                           "--opts", "resume_weights", str(tmp_path / "none.pth")])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == {"config": str(_drill_yaml(tree, tmp_path)), "ok": False,
                    "failed": "preflight"}


@pytest.mark.skipif(not HAVE_REF, reason="reference tree not mounted")
def test_parity_drill_end_to_end(tree, tmp_path):
    from few_shot_seg_cwt_tpu_torch.tools import parity_drill
    from tests.ref_compat import REF

    _, opts = _preflight_assets(tree, tmp_path)
    opts = [o for o in opts if o not in ("image_size", "33")]
    summary = parity_drill.main(["--config", str(_drill_yaml(tree, tmp_path)), "--reference",
                                 REF, "--workdir", str(tmp_path / "drill"), "--device", "cpu",
                                 "--skip-ab", "--opts", *opts])
    assert summary["ok"] and 0.0 <= summary["replay_miou"] <= 1.0


# --------------------------------------------------------------------------- #
# the serving host's side
# --------------------------------------------------------------------------- #


def test_serving_process_imports_only_ops(tmp_path):
    """``tools/serve_loaded.py`` in a fresh process runs a CWT artifact with
    torch and the port's ``ops`` alone (with the launch counters of
    ``utils.tracing``, which ``ops`` imports), and its masks are the
    exporting engine's."""
    from few_shot_seg_cwt_tpu_torch.data.synthetic import make_episode_batch
    from few_shot_seg_cwt_tpu_torch.episodic.engine import EpisodicEngine
    from few_shot_seg_cwt_tpu_torch.tools.export_serve import build_serve_export

    cfg = merge_cfg_from_list(load_cfg(str(REPO / "configs/pascal.yaml")),
                              ["image_size", "33", "adapt_iter", "3"])
    engine = EpisodicEngine(cfg, device="cpu")
    torch.export.save(build_serve_export(cfg, engine, 2), str(tmp_path / "a.pt2"))
    ep = make_episode_batch(2, 2, size=33)
    w0 = engine.init_weights(2, torch.Generator().manual_seed(1))
    torch.save({"s_img": torch.as_tensor(ep["s_img"]), "s_label": torch.as_tensor(ep["s_label"]),
                "q_img": torch.as_tensor(ep["q_img"]), "w0": w0}, tmp_path / "in.pt")
    proc = subprocess.run(
        [sys.executable, "-m", "few_shot_seg_cwt_tpu_torch.tools.serve_loaded",
         str(tmp_path / "a.pt2"), str(tmp_path / "in.pt"), str(tmp_path / "out.pt"),
         "--device", "cpu", "--reps", "1"],
        capture_output=True, text=True, cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1"},
        check=True)
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {m.split(".")[1] for m in result["port_modules"] if "." in m} <= {"ops", "tools",
                                                                              "utils"}
    assert set(result["launches"].values()) == {0}          # the CPU runs the plain versions
    assert torch.equal(torch.load(tmp_path / "out.pt", weights_only=True),
                       engine.serve_batch(ep, w0=w0))
