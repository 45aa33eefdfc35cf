"""Every cell end to end on the CPU at 33 px and 5 inner steps with a short
window: its result line, its comparison passing on the program and failing
on each fault the cell can have; and a cell, a traffic mix and a metric
added as new files only.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import shutil
import time

import pytest
import torch

from benchmark.harness import contract, ddp, faults, readers, runner, trace
from benchmark.harness.spec import BENCH_DIR, ROOT, load_cell
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


@pytest.mark.parametrize("name,fault", [(c, f) for c, fs in faults.BY_CELL.items() for f in fs],
                         ids=lambda x: getattr(x, "__name__", x))
def test_a_fault_is_not_correct(name, fault, monkeypatch, staged_json):
    fault(monkeypatch.setattr)
    monkeypatch.setenv(ddp.FAULT_ENV, fault.__name__)      # and in every other rank
    kw = {"bench_json": staged_json} if name in STAGED else {}
    _, result = run_cell(name, monkeypatch, seed=11, **kw)
    assert not result["correct"], result["checks"]


def test_every_cell_has_its_faults():
    assert set(faults.BY_CELL) == set(CELLS) | set(STAGED)


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
