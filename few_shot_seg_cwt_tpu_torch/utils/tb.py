"""TensorBoard scalar logging (reference parity: tensorboardX in pretrain).

The port's counterpart of ``few_shot_seg_cwt_tpu.utils.tb``: an events file
through ``torch.utils.tensorboard`` when the ``tensorboard`` package
imports; otherwise a JSONL scalars file (``scalars.jsonl``, one
``{"tag", "value", "step"}`` record a line, the JAX package's format) so
the metrics are always recoverable. ``read_scalars`` reads either back.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Tuple


class SummaryWriter:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._tb_writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter as EventsWriter
        except ImportError:
            self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        else:
            self._tb_writer = EventsWriter(log_dir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb_writer is not None:
            self._tb_writer.add_scalar(tag, float(value), global_step=int(step))
        else:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step)}) + "\n")
            self._jsonl.flush()

    def flush(self) -> None:
        if self._tb_writer is not None:
            self._tb_writer.flush()

    def close(self) -> None:
        if self._tb_writer is not None:
            self._tb_writer.close()
        else:
            self._jsonl.close()


def read_scalars(log_dir: str) -> Dict[str, List[Tuple[int, float]]]:
    """The (step, value) records of each tag that ``SummaryWriter`` wrote
    under ``log_dir``: from ``scalars.jsonl`` if there is one, else from
    the events files (which need ``tensorboard`` to read)."""
    out: Dict[str, List[Tuple[int, float]]] = {}
    jsonl = os.path.join(log_dir, "scalars.jsonl")
    if os.path.exists(jsonl):
        with open(jsonl) as f:
            for line in f:
                r = json.loads(line)
                out.setdefault(r["tag"], []).append((int(r["step"]), float(r["value"])))
        return out
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    for path in sorted(glob.glob(os.path.join(log_dir, "events.out.tfevents.*"))):
        acc = EventAccumulator(path)
        acc.Reload()
        for tag in acc.Tags()["scalars"]:
            out.setdefault(tag, []).extend((e.step, e.value) for e in acc.Scalars(tag))
    return out
