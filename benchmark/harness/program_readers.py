"""Readers of the program's own spans in a traced window.

The program marks its phases with ``torch.profiler.record_function`` ranges
named ``fss/<phase>`` (``few_shot_seg_cwt_tpu_torch/utils/tracing.py``):
``fss/eval_batch``, ``fss/serve`` and ``fss/train_step`` bound one item;
inside them ``fss/stage``, ``fss/features``, ``fss/inner_loop``,
``fss/transform``, ``fss/tail``, ``fss/prologue``, ``fss/head_forward``,
``fss/head_backward``, ``fss/optimizer`` and ``fss/consensus`` (the last
also on autograd's thread). ``trace.parse`` keeps them in ``Trace.spans``
under their full names. A reader here works on the union of the
host intervals of several named spans, so that a nested or repeated span
counts once. The host intervals and the device operations come from one
trace on one clock: each reading is arithmetic over intervals measured
together. Where the trace holds none of the named spans (a program without
them) a reader returns None.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Tuple

from .readers import _on_device
from .trace import Trace, _merged

Interval = Tuple[float, float]


def union(trace: Trace, names: Iterable[str]) -> List[Interval]:
    """The union of the host intervals of the spans ``names``, in order."""
    return _merged([iv for name in names for iv in trace.spans.get(name, [])])


def _overlap_us(a: List[Interval], b: List[Interval]) -> float:
    """Microseconds that two ordered lists of disjoint intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def host_ms_within(view, names: Iterable[str]) -> Optional[float]:
    """Host ms per item inside the union of the spans ``names``."""
    if not _on_device(view):
        return None
    spans = union(view.trace, names)
    if not spans:
        return None
    return sum(e - s for s, e in spans) * 1e-3 / view.trace.items


def idle_ms_within(view, names: Iterable[str]) -> Optional[float]:
    """Device idle ms per item while the host is inside any of the spans
    ``names``: their union's length less the device's busy time inside it."""
    if not _on_device(view):
        return None
    spans = union(view.trace, names)
    if not spans:
        return None
    inside = sum(e - s for s, e in spans)
    busy = _overlap_us(spans, view.trace.busy_intervals())
    return (inside - busy) * 1e-3 / view.trace.items


def device_ms_within(view, names: Iterable[str]) -> Optional[float]:
    """Device ms per item of the operations whose launch falls inside the
    union of the spans ``names``."""
    if not _on_device(view):
        return None
    spans = union(view.trace, names)
    if not spans:
        return None
    starts = [s for s, _ in spans]
    total = 0.0
    for _, s, e, launch in view.trace.ops:
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch) - 1
        if i >= 0 and launch <= spans[i][1]:
            total += e - s
    return total * 1e-3 / view.trace.items


def idle_by_phase(trace: Trace, t0: float) -> Dict[str, float]:
    """The window's device idle seconds split by the innermost span (the
    shortest one, of any thread) that held the host at each idle instant;
    "no span" where none did. The window runs from ``t0`` (us, the
    profiler's clock) for ``trace.window_s``; the parts sum to its idle
    time."""
    t1 = t0 + trace.window_s * 1e6
    idle: List[Interval] = []
    cursor = t0
    for s, e in trace.busy_intervals():
        if s > cursor:
            idle.append((cursor, min(s, t1)))
        cursor = max(cursor, e)
    if cursor < t1:
        idle.append((cursor, t1))
    spans = sorted((s, e, name) for name, ivs in trace.spans.items() for s, e in ivs)
    # the instants where the innermost span can change
    cuts = sorted({t for s, e, _ in spans for t in (s, e)})
    out: Dict[str, float] = {}
    for a, b in idle:
        if b <= a:
            continue
        points = [a] + [c for c in cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)]]
        points.append(b)
        for lo, hi in zip(points, points[1:]):
            mid = 0.5 * (lo + hi)
            best, width = "no span", float("inf")
            for s, e, name in spans:
                if s > mid:
                    break
                if mid <= e and e - s < width:
                    best, width = name, e - s
            out[best] = out.get(best, 0.0) + (hi - lo) * 1e-6
    return out
