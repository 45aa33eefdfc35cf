"""Spans and counters of the port.

``span(name)`` marks a phase of a program: the engines' stages, features,
inner loop, transform and tail, the train step's prologue, head forward,
backward and optimizer, and the consensus. While a ``torch.profiler``
records, whoever started it, a span is a ``record_function`` named
``fss/<name>``: it lands in the same trace as the kernels, on the
profiler's clock, and through each launch's host time names the device
work it caused. Spans nest on a thread; one top-level span per program
call (``fss/eval_batch``, ``fss/serve``, ``fss/train_step``) bounds one
item. With no profiler recording, a span is one check of the profiler's
state and a shared no-op context (under a microsecond on the host).

``count(name, n)`` adds to an always-on integer counter: the hand-written
kernels count their launches here, so a run can show that its path went
through a kernel. ``counts()`` is a snapshot (a name never counted reads
0) and ``reset()`` sets every counter back to 0.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter

import torch

PREFIX = "fss/"

_OFF = contextlib.nullcontext()
_counts: Counter = Counter()
_lock = threading.Lock()


def span(name: str):
    """A context manager over the phase ``name``: a profiler range named
    ``fss/<name>`` while a profiler records, else a no-op."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (the autograd thread counts too)."""
    with _lock:
        _counts[name] += n


def counts() -> Counter:
    """A snapshot of every counter; a name never counted reads 0."""
    with _lock:
        return Counter(_counts)


def reset() -> None:
    """Every counter back to 0."""
    with _lock:
        _counts.clear()
