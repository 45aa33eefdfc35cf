"""Every cell end to end on the CPU at 33 px (or its configuration's
``cpu_image_size``) and 5 inner steps with a short window: its result line,
its comparison passing on the program and failing on each fault the cell
can have; and a cell with its configuration, traffic mix, driver, limits,
faults and metrics added as new files only.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import contract, ddp, program, readers, runner, trace
from benchmark.harness.spec import BENCH_DIR, ROOT, fault, faults_by_cell, load_cell
from staged_cells import STAGED, write_staged_json

SHRINK = (33, 5)
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def staged_json(tmp_path_factory):
    return write_staged_json(tmp_path_factory.mktemp("staged") / "BENCHMARK.json")


def run_cell(name, monkeypatch, seed=7, seconds=1.0, traced=False, **kw):
    cell = load_cell(name, **kw)
    for k, v in cell.config.get("env", {}).items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # the other ranks of a cell over cards
    result, found = runner.run(cell, seed, seconds, traced, time.perf_counter(), device="cpu",
                               shrink=SHRINK)
    assert found == []
    json.loads(contract.result_line(result))
    return cell, result


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", CELLS + list(STAGED))
def test_cell_runs_and_is_correct(name, traced, monkeypatch, staged_json):
    kw = {"bench_json": staged_json} if name in STAGED else {}
    cell, result = run_cell(name, monkeypatch, traced=traced, **kw)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    line = contract.result_line(result)
    assert list(json.loads(line))[-1] == "checks"
    want = {m["name"] for m in (cell.per_layer if traced else cell.end_to_end)}
    # a CPU run reports no device metric; the host-clock ones it has
    assert set(result["metrics"]) <= want
    if not traced:
        assert set(result["metrics"]) == want
    else:
        assert {m["name"] for m in cell.per_layer if m["source"] == "host_clock"} <= set(
            result["metrics"])


@pytest.mark.parametrize("name,fault", [(c, f) for c, fs in faults_by_cell().items() for f in fs],
                         ids=lambda x: getattr(x, "__name__", x))
def test_a_fault_is_not_correct(name, fault, monkeypatch, staged_json):
    fault(monkeypatch.setattr)
    monkeypatch.setenv(ddp.FAULT_ENV, fault.__name__)      # and in every other rank
    kw = {"bench_json": staged_json} if name in STAGED else {}
    _, result = run_cell(name, monkeypatch, seed=11, **kw)
    assert not result["correct"], result["checks"]


def test_every_cell_has_its_faults():
    by_cell = faults_by_cell()
    assert set(by_cell) == set(CELLS) | set(STAGED)
    assert all(by_cell.values()), by_cell


def test_a_new_cell_and_metric_are_new_files_only(tmp_path, monkeypatch):
    """A throwaway mix, cell and per-layer metric, added as files and
    entries in a copy, run without an edit to any file already there."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads((bench / "traffic" / "eval_batches.json").read_text())
    traffic.update(batch=2, pool_batches=2, check_batches=1, trace_items=2)
    (bench / "traffic" / "eval_small.json").write_text(json.dumps(traffic))
    (bench / "limits" / "cwt-eval-b2.json").write_text(
        (bench / "limits" / "cwt-eval-b8.json").read_text())
    (bench / "metrics" / "throwaway_ms.py").write_text(
        "def read(view):\n    return sum(view.host['item_ms'])\n")
    spec["workloads"].append({"name": "cwt-eval-b2", "config": "cwt-r50-pascal",
                              "traffic": "eval_small", "chips": 1, "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("cwt-eval-b2")
    spec["per_layer"].append({"name": "throwaway_ms", "unit": "ms", "better": "lower",
                              "source": "host_clock", "layer": "engine: episodic/engine.py",
                              "moves": "eval_episodes_per_s", "workloads": ["cwt-eval-b2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    kw = dict(bench_json=tmp_path / "BENCHMARK.json", bench_dir=bench)
    cell = load_cell("cwt-eval-b2", **kw)
    assert [m["name"] for m in cell.per_layer] == ["throwaway_ms"]
    _, result = run_cell("cwt-eval-b2", monkeypatch, traced=True, **kw)
    assert result["correct"] and "throwaway_ms" in result["metrics"]
    assert all(p.read_bytes() == b for p, b in before.items())


# a throwaway driver: eval_batches's, for a model that, as the CHM head does,
# takes only an even feature side (33 px gives 5, 41 gives 6)
EVEN_DRIVER = '''"""eval_batches for a model that takes an even feature side alone."""

from pathlib import Path

from benchmark.harness.spec import load_module
from benchmark.work import feature_side

_eval = load_module(Path(__file__).with_name("eval_batches.py"))
step, finish, end_to_end, host = _eval.step, _eval.finish, _eval.end_to_end, _eval.host
spans, work, free, readings, control = (_eval.spans, _eval.work, _eval.free, _eval.readings,
                                        _eval.control)


def setup(ctx):
    side = feature_side(ctx.cfg.image_size)
    if side % 2:
        raise ValueError(f"feature side {side} at {ctx.cfg.image_size} px: an even one is taken")
    return _eval.setup(ctx)
'''

# a fault of the throwaway cell's own: intersections cut by a tenth
EVEN_FAULTS = '''"""The faults of cwt-eval-even: one of its own."""


def eval_inter_cut(setattr):
    """Each episode's intersection areas cut by a tenth where they are produced."""
    from few_shot_seg_cwt_tpu_torch.episodic.engine import EpisodicEngine

    orig = EpisodicEngine.eval_metrics_batch

    def cut(self, *a, **k):
        out = orig(self, *a, **k)
        out["inter"] = out["inter"] * 0.9
        return out

    setattr(EpisodicEngine, "eval_metrics_batch", cut)


FAULTS = [eval_inter_cut]
'''

# a metric over one of the program's spans: host ms an item inside fss/tail
TAIL_METRIC = '''from benchmark.harness import program_readers


def read(view):
    tail = program_readers.union(view.trace, ("fss/tail",))
    return sum(e - s for s, e in tail) * 1e-3 / view.trace.items if tail else None
'''


def test_a_new_cell_with_its_driver_faults_and_cpu_size_is_new_files_only(tmp_path, monkeypatch):
    """A throwaway cell whose configuration states ``cpu_image_size`` 41,
    with a new driver that takes only an even feature side, its traffic
    and limits, a faults file with a fault of its own and a metric over a
    ``fss/`` span: added as files and entries in a copy, it runs correct
    on the CPU at 41 px, its fault fails it, ``control.py`` finds the fault
    by the cell's name, and no byte of a file already there changed."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    config = json.loads((bench / "configs" / "cwt-r50-pascal.json").read_text())
    config.update(name="cwt-r50-even", cpu_image_size=41)
    (bench / "configs" / "cwt-r50-even.json").write_text(json.dumps(config))
    (bench / "drivers" / "eval_even.py").write_text(EVEN_DRIVER)
    traffic = json.loads((bench / "traffic" / "eval_batches.json").read_text())
    traffic.update(driver="eval_even", batch=2, pool_batches=2, check_batches=1, trace_items=2)
    (bench / "traffic" / "eval_even.json").write_text(json.dumps(traffic))
    (bench / "limits" / "cwt-eval-even.json").write_text(
        (bench / "limits" / "cwt-eval-b8.json").read_text())
    (bench / "faults" / "cwt-eval-even.py").write_text(EVEN_FAULTS)
    (bench / "metrics" / "tail_host_ms.even.py").write_text(TAIL_METRIC)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "cwt-r50-even", "source": "a test",
                            "file": "benchmark/configs/cwt-r50-even.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "cwt-eval-even", "config": "cwt-r50-even",
                              "traffic": "eval_even", "chips": 1, "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("cwt-eval-even")
    spec["per_layer"].append({"name": "tail_host_ms.even", "unit": "ms", "better": "lower",
                              "source": "program_span", "layer": "engine: episodic/engine.py",
                              "moves": "eval_episodes_per_s", "workloads": ["cwt-eval-even"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    kw = dict(bench_json=tmp_path / "BENCHMARK.json", bench_dir=bench)

    cell = load_cell("cwt-eval-even", **kw)
    assert [m["name"] for m in cell.per_layer] == ["tail_host_ms.even"]
    assert program.port_cfg(cell.config, SHRINK).image_size == 41
    assert program.port_cfg(load_cell("cwt-eval-b8").config, SHRINK).image_size == SHRINK[0]
    _, result = run_cell("cwt-eval-even", monkeypatch, traced=True, **kw)
    assert result["correct"], result["checks"]
    assert result["metrics"]["tail_host_ms.even"]["value"] > 0

    planted = fault(cell, "eval_inter_cut")
    assert [f.__name__ for f in faults_by_cell(bench)["cwt-eval-even"]] == [planted.__name__]
    with monkeypatch.context() as m:
        planted(m.setattr)
        _, result = run_cell("cwt-eval-even", monkeypatch, seed=11, **kw)
    assert not result["correct"], result["checks"]

    # control.py resolves the fault through the cell before it looks for a card
    def control(name):
        return subprocess.run([sys.executable, str(bench / "control.py"), "--workload",
                               "cwt-eval-even", "--seeds", "1", "--fault", name],
                              capture_output=True, text=True, timeout=300,
                              env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    found, missing = control("eval_inter_cut"), control("eval_answer_altered")
    assert found.returncode == 2 and "reads the card" in found.stderr, found.stderr[-2000:]
    assert missing.returncode == 1, missing.stderr[-2000:]
    assert "cwt-eval-even has no fault 'eval_answer_altered'" in missing.stderr
    assert all(p.read_bytes() == b for p, b in before.items())


def test_service_shares_are_taken_over_the_request_spans():
    """Two requests of 10 us each in a 100 us window, the device busy 4 us
    inside the first (one op across its end) and 5 inside the second."""
    tr = trace.Trace(window_s=100e-6, items=2,
                     ops=[("a", 5.0, 12.0, 5.0), ("b", 50.0, 55.0, 50.0)],
                     spans={"request": [(0.0, 10.0), (50.0, 60.0)]})
    assert tr.span_total_s("request") == pytest.approx(20e-6)
    assert tr.busy_within_s("request") == pytest.approx(10e-6)
    view = runner.Readout(device=torch.device("cuda"), trace=tr, host={},
                          work={"flops_per_item": 1e6})
    assert readers.service_idle_pct(view, "request") == pytest.approx(50.0)
    assert readers.idle_pct(view) == pytest.approx(88.0)
    share = readers.service_mfu_pct(view, "request")
    assert share == pytest.approx(100.0 * 2e6 / (readers.PEAK_FP32_FLOPS * 20e-6))
    assert readers.service_mfu_pct(view, "missing") is None
