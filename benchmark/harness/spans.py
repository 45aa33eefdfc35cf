"""Spans the benchmark places around the program's layers, from its own
files: each wraps a callable in ``torch.profiler.record_function`` named
``bench::<layer>``, so the profiler's trace holds the span's host interval
and, through the launch of each kernel inside it, the device work it
caused. Installed only for a traced run; the timed run carries none."""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Iterator, List

from torch.profiler import record_function

PREFIX = "bench::"


def span(name: str):
    return record_function(PREFIX + name)


@contextlib.contextmanager
def wrapped(targets) -> Iterator[None]:
    """Within the block, each (owner, attribute, layer) of ``targets`` runs
    inside the span ``layer``; the attributes are restored on exit."""
    undo: List[Callable[[], None]] = []
    try:
        for owner, attr, layer in targets:
            own = attr in vars(owner)
            orig = getattr(owner, attr)

            @functools.wraps(orig)
            def inner(*args, __orig=orig, __layer=layer, **kwargs):
                with span(__layer):
                    return __orig(*args, **kwargs)

            setattr(owner, attr, inner)
            undo.append((lambda o=owner, a=attr, f=orig: setattr(o, a, f)) if own
                        else (lambda o=owner, a=attr: delattr(o, a)))
        yield
    finally:
        for fn in reversed(undo):
            fn()
