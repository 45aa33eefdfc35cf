"""What the benchmark may import, by an AST scan of every file under
``benchmark/`` and by ``sys.modules`` after a CPU cell in a fresh process;
and what ``run.py`` does without a card. Module names are compared by their
top-level name whole: ``few_shot_seg_cwt_tpu_torch`` is the program,
``few_shot_seg_cwt_tpu`` the JAX package."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

from benchmark.harness.contract import forbidden_modules
from benchmark.harness.spec import BENCH_DIR, ROOT

JAX_STACK = {"jax", "jaxlib", "flax", "few_shot_seg_cwt_tpu"}
PROGRAM = "few_shot_seg_cwt_tpu_torch"


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_file_imports_the_jax_stack_and_the_reference_not_the_program():
    files = sorted(BENCH_DIR.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        roots = imported_roots(path)
        assert not roots & JAX_STACK, (path, roots & JAX_STACK)
        if "reference" in path.relative_to(BENCH_DIR).parts:
            assert PROGRAM not in roots and "benchmark" not in roots, (path, roots)


def test_forbidden_names_compare_whole():
    assert forbidden_modules(["few_shot_seg_cwt_tpu_torch.ops", "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "few_shot_seg_cwt_tpu.models", "flax"]) == [
        "few_shot_seg_cwt_tpu.models", "flax", "jax.numpy"]


CELL_IN_FRESH_PROCESS = r"""
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
from benchmark.harness.spec import load_cell
cell = load_cell("mmn-train-b2")
os.environ.update(cell.config["env"])
from benchmark.harness import runner
result, found = runner.run(cell, 5, 0.5, False, time.perf_counter(), device="cpu", shrink=(33, 3))
print(json.dumps({"found": found, "correct": result["correct"],
                  "modules": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_a_cell_loads_nothing_of_the_jax_stack():
    out = subprocess.run([sys.executable, "-c", CELL_IN_FRESH_PROCESS, str(ROOT)],
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["found"] == [] and got["correct"]
    assert not set(got["modules"]) & JAX_STACK
    assert PROGRAM in got["modules"]


def _run(cwd, workload="cwt-eval-b8"):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                           "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def _no_result(out):
    for line in out.stdout.splitlines():
        try:
            assert "correct" not in json.loads(line)
        except ValueError:
            pass


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    _no_result(out)


def test_run_with_only_the_benchmark_exits_nonzero(tmp_path):
    """Without a card, as here, ``run.py`` stops at the card; past that
    check (the harness's run on the CPU) the program is missing."""
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0
    _no_result(out)
    past_the_card = ("import sys, time; sys.path.insert(0, '.');"
                     "from benchmark.harness import runner, spec;"
                     "runner.run(spec.load_cell('cwt-eval-b8'), 1, 1, False, time.perf_counter(),"
                     " device='cpu', shrink=(33, 3))")
    out = subprocess.run([sys.executable, "-c", past_the_card], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and PROGRAM in out.stderr, out.stderr[-2000:]
    _no_result(out)
