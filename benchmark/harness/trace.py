"""The traced window: ``torch.profiler`` over a fixed number of the cell's
items, and the reduction of its trace to what the per-layer metrics read.

The profiler's Chrome trace goes to a file in ``TMPDIR``, is read back and
deleted. From it: every device operation (kernel, copy, set) with its
interval; the host time of each launch (by its correlation id); the
benchmark's ``bench::`` spans, under their names without the prefix; and the
program's own ``fss/`` spans, under their full names, so that neither set
can take the other's name. A kernel belongs to a span when the host
launched it inside the span's interval.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .spans import PREFIX

# the prefix of the program's spans (few_shot_seg_cwt_tpu_torch/utils/tracing.py)
PROGRAM_PREFIX = "fss/"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    """Device operations (name, start us, end us, launch us or None) and
    spans {layer: [(start us, end us)]} of one traced window: the
    benchmark's by their layer, the program's by their ``fss/`` names."""
    window_s: float
    items: int
    ops: List[Tuple[str, float, float, Optional[float]]] = field(default_factory=list)
    spans: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)
    # over several cards, every rank's busy seconds (this rank's among them)
    rank_busy_s: List[float] = field(default_factory=list)

    def busy_intervals(self) -> List[Tuple[float, float]]:
        return _merged([(s, e) for _, s, e, _ in self.ops])

    @property
    def own_busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    @property
    def busy_s(self) -> float:
        """Seconds in which an operation ran on the device, averaged over
        the cards where the window spans several."""
        if self.rank_busy_s:
            return sum(self.rank_busy_s) / len(self.rank_busy_s)
        return self.own_busy_s

    def span_count(self, layer: str) -> int:
        return len(self.spans.get(layer, []))

    def span_device_s(self, layer: str) -> Optional[float]:
        """Device seconds of the operations launched inside the spans named
        ``layer``; None where there is no such span."""
        spans = sorted(self.spans.get(layer, []))
        if not spans:
            return None
        starts = [s for s, _ in spans]
        total = 0.0
        for _, s, e, launch in self.ops:
            if launch is None:
                continue
            i = bisect.bisect_right(starts, launch) - 1
            if i >= 0 and launch <= spans[i][1]:
                total += e - s
        return total * 1e-6

    def span_total_s(self, layer: str) -> Optional[float]:
        """Seconds of host time inside the spans named ``layer`` (which do
        not overlap one another); None where there is no such span."""
        spans = _merged(self.spans.get(layer, []))
        return sum(e - s for s, e in spans) * 1e-6 if spans else None

    def busy_within_s(self, layer: str) -> float:
        """Seconds in which a device operation ran inside the host intervals
        of the spans named ``layer``."""
        spans = _merged(self.spans.get(layer, []))
        starts = [a for a, _ in spans]
        total = 0.0
        for s, e in self.busy_intervals():
            i = max(0, bisect.bisect_right(starts, s) - 1)
            while i < len(spans) and spans[i][0] < e:
                total += max(0.0, min(e, spans[i][1]) - max(s, spans[i][0]))
                i += 1
        return total * 1e-6

    def ops_s(self, match: Callable[[str], bool]) -> float:
        return sum(e - s for name, s, e, _ in self.ops if match(name)) * 1e-6

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        """The device operations that took most time, and the longest idle
        gaps, each named by the operation that ended it and the span whose
        host interval held that operation's launch."""
        by_name: Dict[str, float] = defaultdict(float)
        for name, s, e, _ in self.ops:
            by_name[name[:160]] += (e - s) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        firsts = sorted(self.ops, key=lambda o: o[1])
        starts = [o[1] for o in firsts]
        gaps = []
        busy = self.busy_intervals()
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            i = bisect.bisect_left(starts, s1)
            name, _, _, launch = firsts[min(i, len(firsts) - 1)]
            gaps.append((f"before {name[:100]} ({self.layer_at(launch)})", (s1 - e0) * 1e-6))
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in gaps[:top]]}

    def layer_at(self, t: Optional[float]) -> str:
        """The innermost span holding host time ``t``."""
        best, width = "no span", float("inf")
        if t is None:
            return best
        for layer, spans in self.spans.items():
            for s, e in spans:
                if s <= t <= e and e - s < width:
                    best, width = layer, e - s
        return best


def _merged(intervals) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals, in order."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def parse(events: List[Dict], window_s: float, items: int) -> Trace:
    launches = {}
    for ev in events:
        if ev.get("cat") in LAUNCH_CATS and "correlation" in ev.get("args", {}):
            launches[ev["args"]["correlation"]] = float(ev["ts"])
    out = Trace(window_s=window_s, items=items)
    for ev in events:
        cat = ev.get("cat")
        if ev.get("ph") != "X":
            continue
        if cat in DEVICE_CATS:
            s = float(ev["ts"])
            corr = ev.get("args", {}).get("correlation")
            out.ops.append((ev["name"], s, s + float(ev.get("dur", 0.0)), launches.get(corr)))
        elif cat == "user_annotation" and ev["name"].startswith((PREFIX, PROGRAM_PREFIX)):
            name = ev["name"]
            s = float(ev["ts"])
            out.spans.setdefault(name[len(PREFIX):] if name.startswith(PREFIX) else name,
                                 []).append((s, s + float(ev.get("dur", 0.0))))
    return out


def traced_window(state, items: int, device: torch.device, step: Callable[[int], None]) -> Trace:
    """The one-card traced window of a cell (``runner``'s default)."""
    return traced(step, items, device)


def traced(step: Callable[[int], None], items: int, device: torch.device) -> Trace:
    """Run ``step(i)`` for i < ``items`` under the profiler, the device
    synchronised at both ends; the window is the host time between them."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(items):
            step(i)
        sync()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return parse(events, window_s, items)
