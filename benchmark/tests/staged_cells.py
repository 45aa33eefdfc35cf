"""Cells whose files the harness holds but ``BENCHMARK.json`` does not list
yet (PERF.md, Open questions), with the entries a later PR would add, so
that the CPU tests keep their path running."""

from __future__ import annotations

import json
from pathlib import Path

from benchmark.harness.spec import ROOT

STAGED = {"mmn-ddp4-train": (
    {"name": "mmn-ddp4-train", "config": "mmn-r50-pascal", "traffic": "ddp_train_steps",
     "chips": 4, "why": "train_ddp: 4 ranks x 2 episodes a step, NCCL gradient all-reduce"},
    [{"name": "allreduce_ms.train", "unit": "ms", "better": "lower", "source": "device_trace",
      "layer": "scale-out: parallel/mesh.py", "moves": "train_samples_per_s",
      "workloads": ["mmn-ddp4-train"]}])}


def write_staged_json(path: Path) -> Path:
    """``BENCHMARK.json`` with the staged cells' entries added, at ``path``."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for workload, per_layer in STAGED.values():
        spec["workloads"].append(workload)
        for m in spec["end_to_end"]:
            if m["name"] == "train_samples_per_s":
                m["workloads"].append(workload["name"])
        spec["per_layer"] += per_layer
    path.write_text(json.dumps(spec))
    return path
