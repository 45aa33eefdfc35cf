"""Tee logging: a trainer's lines to its sink and appended to a log file
(reference: src/util.py:81-90).

The port's copy of ``few_shot_seg_cwt_tpu.utils.logging``. Several
processes: only rank 0 writes (the ``RANK`` environment variable, 0 when
unset, in place of ``jax.process_index()``; the reference's
``main_process()`` gating, src/train_ddp.py:40-44), so trainers stay
process-count-agnostic.
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Optional

_log_path: Optional[str] = None


def log_to(path: Optional[str]) -> None:
    """Set (or clear) the directory that receives log.txt appends.

    Stored absolute so the tee survives a later working-directory change
    (the registered path outlives the trainer call that set it).
    """
    global _log_path
    _log_path = os.path.abspath(path) if path is not None else None
    if path is not None:
        os.makedirs(_log_path, exist_ok=True)


def get_logger(sink: Callable = print) -> Callable:
    """A print-like callable that hands each line to ``sink`` (``print`` by
    default) and appends it to ``<path>/log.txt`` once ``log_to`` named a
    directory. A process of rank other than 0 gets a no-op. The rank is
    read at call time, after the trainer's own set-up."""

    def log(obj, filename: str = "log.txt"):
        if int(os.environ.get("RANK", "0")) != 0:
            return
        sink(obj)
        sys.stdout.flush()
        if _log_path is not None:
            with open(os.path.join(_log_path, filename), "a") as f:
                print(obj, file=f)

    return log
