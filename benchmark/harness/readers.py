"""What the per-layer readers share. Each reader (``metrics/<name>.py``)
is one ``read(view)`` over a ``runner.Readout``; these are the quantities
several of them take. A device quantity is None without a device trace."""

from __future__ import annotations

from statistics import median
from typing import Callable, Optional

from ..work import PEAK_FP32_FLOPS


def _on_device(view) -> bool:
    return view.device.type == "cuda" and view.trace is not None and bool(view.trace.ops)


def host_median_ms(view) -> Optional[float]:
    ms = view.host.get("item_ms", [])
    return median(ms) if ms else None


def span_ms_per_call(view, layer: str) -> Optional[float]:
    """Device ms of the operations launched inside ``layer``'s spans, per span."""
    if not _on_device(view):
        return None
    s = view.trace.span_device_s(layer)
    return None if s is None else s * 1e3 / view.trace.span_count(layer)


def span_roofline_pct(view, layer: str, bound_key: str) -> Optional[float]:
    """The bound of one call of ``layer`` (``view.work[bound_key]`` ms) over
    its device ms per span."""
    ms = span_ms_per_call(view, layer)
    return None if not ms else 100.0 * view.work[bound_key] / ms


def kernels_roofline_pct(view, match: Callable[[str], bool], bound_key: str
                         ) -> Optional[float]:
    """The bound of an item's calls (``view.work[bound_key]`` ms, per item)
    over the device time of the operations ``match`` names, per item."""
    if not _on_device(view):
        return None
    s = view.trace.ops_s(match)
    if s <= 0:
        return None
    return 100.0 * view.work[bound_key] * view.trace.items / (s * 1e3)


def mfu_pct(view) -> Optional[float]:
    """The cell's model FLOPs of the traced items over fp32's peak (TF32
    off) on every card of the cell and the traced window."""
    if not _on_device(view):
        return None
    flops = view.work["flops_per_item"] * view.trace.items
    return 100.0 * flops / (PEAK_FP32_FLOPS * view.work.get("chips", 1) * view.trace.window_s)


def idle_pct(view) -> Optional[float]:
    """The share of the traced window in which no device operation ran."""
    if not _on_device(view):
        return None
    return 100.0 * (1.0 - view.trace.busy_s / view.trace.window_s)


def service_mfu_pct(view, layer: str) -> Optional[float]:
    """The cell's model FLOPs of the traced items over fp32's peak and the
    summed host time of the spans ``layer``, one an item: for a cell whose
    window's length the client's pacing sets."""
    if not _on_device(view):
        return None
    total = view.trace.span_total_s(layer)
    if not total:
        return None
    flops = view.work["flops_per_item"] * view.trace.span_count(layer)
    return 100.0 * flops / (PEAK_FP32_FLOPS * view.work.get("chips", 1) * total)


def service_idle_pct(view, layer: str) -> Optional[float]:
    """The share of the spans ``layer``'s summed host time in which no
    device operation ran."""
    if not _on_device(view):
        return None
    total = view.trace.span_total_s(layer)
    if not total:
        return None
    return 100.0 * (1.0 - view.trace.busy_within_s(layer) / total)
