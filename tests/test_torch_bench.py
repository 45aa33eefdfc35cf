"""The port's bench (``tools/bench.py``) in every mode on the CPU at 33 px,
2 inner steps and 2 timed batches: each JSON line carries its fields with
finite values, names the CPU, and gives no device figure (utilisation,
peak, memory) for a CPU run. Without a card and without ``device="cpu"``
it raises. The rates themselves are the CPU's and mean nothing here.
"""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from few_shot_seg_cwt_tpu_torch.tools import bench

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FINITE = ("value", "median_batch_ms", "rate_p10", "rate_p50", "rate_p90", "warmup_s",
          "flops_per_episode", "kernel_flops_per_episode")


@pytest.mark.parametrize("mode", bench.MODES)
def test_every_mode_runs_on_the_cpu(mode):
    out = bench.run(mode, device="cpu", image_size=33, adapt_iter=2, batches=2,
                    episode_batch=2, pretrain_batch=2, quiet=1)
    json.dumps(out)
    assert out["mode"] == mode and out["timed_batches"] == 2 and out["batch"] == 2
    assert out["unit"] == ("images/s" if mode == "pretrain" else "episodes/s")
    for k in FINITE:
        assert math.isfinite(out[k]), k
    assert out["value"] > 0 and out["flops_per_episode"] > 0
    assert out["rate_p10"] <= out["rate_p50"] <= out["rate_p90"]
    assert out["platform"] == out["device"] == "cpu"
    assert out["mfu"] is None and out["peak_mem_gib"] is None and out["card"] is None
    assert out["kernel_launches"] == {}           # CPU tensors launch no kernel


def test_bench_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run("eval")
    # the command line, as a user runs it
    proc = subprocess.run([sys.executable, "-m", "few_shot_seg_cwt_tpu_torch.tools.bench"],
                          cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "BENCH_QUIET": "1"})
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert proc.stdout == ""


@pytest.mark.parametrize("knobs,error", [
    ({"head": "chm"}, "ROADMAP queue 1 item 8"),
    ({"head": "cca"}, "ROADMAP queue 1 item 11"),
])
def test_heads_not_ported_name_their_item(knobs, error):
    with pytest.raises(NotImplementedError, match=error):
        bench.run("head_eval", device="cpu", image_size=33, adapt_iter=2, batches=1,
                  episode_batch=1, quiet=1, **knobs)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="BENCH_MODE"):
        bench.run("serve", device="cpu")
