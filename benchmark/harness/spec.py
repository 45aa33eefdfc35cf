"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell names its configuration (``configs/<config>.json``) and its traffic
mix (``traffic/<traffic>.json``, which names its driver,
``drivers/<driver>.py``); its comparison limits are ``limits/<cell>.json``,
the faults it can have are ``faults/<cell>.py`` (its ``FAULTS``, functions
defined there or taken from ``harness/faults.py``), and each per-layer
metric is read by ``metrics/<metric>.py``. A later cell, mix or metric is
new files and entries; no file here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]
    run_seconds: int
    bench_dir: Path
    bench_json: Path


def load_module(path: Path) -> ModuleType:
    """A benchmark file as a module (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"bench_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench_json: Path = ROOT / "BENCHMARK.json",
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` with its configuration, traffic, limits and the
    metrics it reports: an end-to-end metric that lists the cell (or lists
    no cells), and a per-layer metric that lists it (or lists none and
    moves a metric the cell reports)."""
    spec = _read(bench_json)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}: one of {sorted(cells)}")
    w = cells[name]
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(name=name, chips=int(w["chips"]),
                config=_read(bench_dir / "configs" / f"{w['config']}.json"),
                traffic=_read(bench_dir / "traffic" / f"{w['traffic']}.json"),
                limits=_read(bench_dir / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer, run_seconds=int(spec["run_seconds"]),
                bench_dir=bench_dir, bench_json=bench_json)


def driver(cell: Cell) -> ModuleType:
    return load_module(cell.bench_dir / "drivers" / f"{cell.traffic['driver']}.py")


def metric_reader(cell: Cell, name: str) -> ModuleType:
    return load_module(cell.bench_dir / "metrics" / f"{name}.py")


def fault(cell: Cell, name: str) -> Callable:
    """The fault called ``name`` among the cell's (``faults/<cell>.py``)."""
    found = {f.__name__: f
             for f in load_module(cell.bench_dir / "faults" / f"{cell.name}.py").FAULTS}
    if name not in found:
        raise SystemExit(f"{cell.name} has no fault {name!r}: one of {sorted(found)}")
    return found[name]


def faults_by_cell(bench_dir: Path = BENCH_DIR) -> Dict[str, List[Callable]]:
    """{cell: its faults} over every file under ``faults/``."""
    return {p.stem: list(load_module(p).FAULTS)
            for p in sorted((bench_dir / "faults").glob("*.py"))}
