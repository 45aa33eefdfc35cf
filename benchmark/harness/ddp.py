"""A cell over several cards: one process a card, as ``torchrun`` starts
them, in one process group.

The process that runs ``run.py`` is rank 0. It starts ranks 1..world-1 as
fresh processes of this module (``python -m benchmark.harness.ddp``), each
bound to its card by the program's ``parallel.mesh.distributed_init``
(NCCL), and steers them through a second group on gloo, on the host: each
message is one small broadcast from rank 0 (run the next item, end the
window, run a traced window, end), so every rank runs the same items and no
collective of the program waits on a rank that has stopped. Every rank
sets up alike from the seed; rank 0 alone prints the result and runs the
reference, and the others send it what the driver's ``report`` gives when
the window ends (their peak memory, their losses of the checked steps) and
their traced window's busy time.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List

import torch
import torch.distributed as dist

from .spec import ROOT

GO, STOP, TRACE, END = 1, 2, 3, 4
RANK_KEYS = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# the name of a fault of the cell that every rank plants (tests and control.py)
FAULT_ENV = "BENCHMARK_FAULT"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> Dict[str, str]:
    return dict(zip(RANK_KEYS, (str(rank), str(rank), str(world), "localhost", str(port))))


class Group:
    """Rank 0's handle on the workers it started and on the control group."""

    def __init__(self, workers: List[subprocess.Popen]):
        self.workers = workers
        self.control = dist.new_group(backend="gloo")

    def send(self, kind: int, arg: int = 0) -> None:
        dist.broadcast(torch.tensor([kind, arg], dtype=torch.int64), 0, group=self.control)

    def gather(self, obj) -> List:
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, obj, group=self.control)
        return out

    def close(self, timeout: float = 120.0) -> None:
        """END to the workers; every rank leaves the group at once (NCCL's
        teardown waits for the other ranks); wait for each worker to exit."""
        try:
            self.send(END)
            dist.barrier(group=self.control)
            dist.destroy_process_group()
        finally:
            deadline = time.monotonic() + timeout
            for p in self.workers:
                try:
                    p.wait(max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            for k in RANK_KEYS:
                os.environ.pop(k, None)
        bad = [p.returncode for p in self.workers if p.returncode != 0]
        if bad:
            raise RuntimeError(f"ranks exited with {bad}")


def start(cell, seed: int, world: int, device, shrink=None) -> Group:
    """Start ranks 1..world-1 (they inherit the environment, the route with
    it), then join the group as rank 0, bound to its card."""
    from few_shot_seg_cwt_tpu_torch.parallel.mesh import distributed_init

    port = free_port()
    kind = torch.device(device).type
    workers = []
    for r in range(1, world):
        cmd = [sys.executable, "-m", "benchmark.harness.ddp", "--workload", cell.name,
               "--seed", str(seed), "--device", kind, "--bench-json", str(cell.bench_json),
               "--bench-dir", str(cell.bench_dir)]
        if shrink is not None:
            cmd += ["--shrink", f"{shrink[0]},{shrink[1]}"]
        workers.append(subprocess.Popen(cmd, cwd=ROOT,
                                        env=dict(os.environ, **rank_env(r, world, port))))
    os.environ.update(rank_env(0, world, port))
    distributed_init(device=kind)
    return Group(workers)


def worker(cell_name: str, seed: int, device: str, shrink, bench_json: str,
           bench_dir: str) -> None:
    """Rank r: join the group, set up as rank 0 does, follow its messages."""
    from few_shot_seg_cwt_tpu_torch.parallel.mesh import distributed_init

    from . import runner, trace
    from .spec import fault, load_cell

    cell = load_cell(cell_name, Path(bench_json), Path(bench_dir))
    os.environ.update(cell.config.get("env", {}))
    if os.environ.get(FAULT_ENV):
        fault(cell, os.environ[FAULT_ENV])(setattr)
    if device == "cuda":                   # this rank's card
        device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
    distributed_init(device=device)
    control = dist.new_group(backend="gloo")
    drv, ctx, state = runner.prepare(cell, seed, device, shrink)
    records: List = []
    msg = torch.zeros(2, dtype=torch.int64)

    def gather(obj) -> None:
        dist.all_gather_object([None] * dist.get_world_size(), obj, group=control)

    while True:
        dist.broadcast(msg, 0, group=control)
        kind, arg = int(msg[0]), int(msg[1])
        if kind == GO:
            records.append(drv.step(state, len(records)))
        elif kind == STOP:
            drv.finish(state, records)
            gather(drv.report(state, records))
        elif kind == TRACE:
            offset = len(records)
            tr = trace.traced(lambda k: records.append(drv.step(state, offset + k)), arg,
                              ctx.device)
            gather({"busy_s": tr.busy_s})
        elif kind == END:
            break
    dist.barrier(group=control)
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description="one worker rank of a multi-card cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shrink", default=None)
    ap.add_argument("--bench-json", required=True)
    ap.add_argument("--bench-dir", required=True)
    a = ap.parse_args()
    worker(a.workload, a.seed, a.device,
           tuple(int(x) for x in a.shrink.split(",")) if a.shrink else None,
           a.bench_json, a.bench_dir)


if __name__ == "__main__":
    main()
