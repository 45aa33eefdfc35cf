"""The port's trainers over two processes on the CPU (gloo): ``train_cwt``,
``train_ddp`` (the MMN head trainer) and ``pretrain`` at ``WORLD_SIZE`` 2,
started by ``python -m few_shot_seg_cwt_tpu_torch.parallel.dryrun --checks
trainers`` (17 px, synthetic episodes and records) in a directory under
``tmp_path``.

* Both ranks return the same best mIoU from every trainer (``train_cca``
  too); ``train_cca1`` refuses a process group.
* Rank 0 alone writes: each ``log.txt`` holds every validation line once.
* Exact resume at world 2: a run cut after one epoch and resumed by
  ``auto_resume`` ends with the uninterrupted run's weights, bit for bit;
  its train state holds both ranks' generator states and the world size.
* A world-2 train state resumed by one process raises, naming both sizes.
* The CHM and DeTr train steps (``--checks chm,detr``, 33 px; CHM at 41)
  at world 2 equal one process running the ranks' slices, within 1e-3 of
  each gradient tensor's largest entry, with the parameters equal on both
  ranks after the step.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from few_shot_seg_cwt_tpu_torch.config import default_cfg, merge_cfg_from_list
from few_shot_seg_cwt_tpu_torch.parallel.dryrun import default_spec
from few_shot_seg_cwt_tpu_torch.train import train_cwt
from few_shot_seg_cwt_tpu_torch.utils.ckpt import load_ckpt

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    work = tmp_path_factory.mktemp("trainers")
    spec = default_spec(17, 2, ["trainers"])
    spec["trainers"] = {"size": 17, "dir": str(work / "runs")}
    (work / "runs").mkdir()
    torch.save(spec, work / "spec.in.pt")
    proc = subprocess.run(
        [sys.executable, "-m", "few_shot_seg_cwt_tpu_torch.parallel.dryrun", "--world", "2",
         "--backend", "gloo", "--device", "cpu", "--spec", str(work / "spec.in.pt"),
         "--out", str(work), "--threads", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    row = next(r for r in rows if r["check"] == "trainers")
    yield row["results"], work / "runs"
    shutil.rmtree(work)   # the runs' checkpoints, ~0.7 GB


def _one(root: Path, pattern: str) -> Path:
    found = sorted(root.rglob(pattern))
    assert len(found) == 1, (pattern, found)
    return found[0]


def test_both_ranks_return_the_same_scores(trainers):
    results, _ = trainers
    assert len(results) == 2
    for key in ("cwt_whole", "cwt_resumed", "head_whole", "head_resumed", "pretrain", "cca"):
        assert results[0][key] == results[1][key], key
        assert 0.0 <= results[0][key] <= 1.0, key
    # the adaptive CCA trainer is single-process, as in the JAX package
    for r in results:
        assert r["cca1_refused"] and "one process" in r["cca1_refused"]


@pytest.mark.parametrize("run, line, count", [
    ("cwt_whole/**/log.txt", "mIoU---Val result", 2),
    ("whole/log.txt", "val: mIoU", 2),
    ("ddp/log.txt", "Testing results", 1),
    ("cca/log.txt", "val: mIoU", 1),
])
def test_rank_0_alone_writes_the_logs(trainers, run, line, count):
    _, runs = trainers
    lines = _one(runs, run).read_text().splitlines()
    assert sum(line in entry for entry in lines) == count, lines


@pytest.mark.parametrize("trainer, final, state, n_rng", [
    ("cwt", "final.pth", "train_state.pth", 5056),
    ("head", "final.pt", "train_state.pt", 5056),
])
def test_exact_resume_at_world_2(trainers, trainer, final, state, n_rng):
    _, runs = trainers
    prefix = "cwt_" if trainer == "cwt" else ""
    want = load_ckpt(str(_one(runs, f"{prefix}whole/**/{final}")))
    got = load_ckpt(str(_one(runs, f"{prefix}cut/**/{final}")))
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    saved = load_ckpt(str(_one(runs, f"{prefix}cut/**/{state}")))
    assert saved["meta"]["world"] == 2 and saved["meta"]["epoch"] in (2,)
    assert tuple(saved["rng_ranks"].shape) == (2, n_rng)
    assert torch.equal(saved["rng_ranks"][0], saved["rng"])


def test_pretrain_writes_its_checkpoints_and_scalars_once(trainers):
    _, runs = trainers
    run = _one(runs, "ddp/final.ckpt").parent
    assert {p.name for p in run.iterdir()} >= {"best.ckpt", "final.ckpt", "train_state.ckpt",
                                               "log.txt", "model"}
    state = load_ckpt(str(run / "train_state.ckpt"))
    assert state["meta"]["world"] == 2 and tuple(state["rng_ranks"].shape) == (2, 5056)


def test_a_world_2_state_does_not_resume_on_one_process(trainers, tmp_path):
    _, runs = trainers
    state = _one(runs, "cwt_cut/**/train_state.pth")
    cfg = merge_cfg_from_list(default_cfg(), [
        "image_size", "17", "adapt_iter", "2", "synthetic_data", "True", "epochs", "3",
        "iter_per_epoch", "8", "episode_batch", "4", "test_num", "4", "n_runs", "1",
        "save_models", "False", "model_dir", str(tmp_path), "workers", "0"])
    cfg.resume_ckpt = str(state)
    with pytest.raises(ValueError, match="written by 2 process.*this run has 1"):
        train_cwt.main(cfg, device="cpu", log=lambda *_: None)


@pytest.fixture(scope="module")
def head_steps(tmp_path_factory):
    work = tmp_path_factory.mktemp("head_steps")
    proc = subprocess.run(
        [sys.executable, "-m", "few_shot_seg_cwt_tpu_torch.parallel.dryrun", "--world", "2",
         "--backend", "gloo", "--device", "cpu", "--size", "33", "--adapt-iter", "3",
         "--checks", "chm,detr", "--out", str(work), "--threads", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:] + proc.stdout[-4000:]
    return {r["check"]: r for r in (json.loads(line) for line in proc.stdout.splitlines()
                                    if line.startswith("{"))}


@pytest.mark.parametrize("head", ["chm", "detr"])
def test_chm_and_detr_steps_at_world_2_equal_one_process(head_steps, head):
    row = head_steps[f"{head}_step"]
    assert row["ok"], row
    assert row["max_rel_err"] <= 1e-3 and row["world1_max_rel_err"] <= 1e-3
    assert row["grads_live"] and row["params_equal_across_ranks"]
