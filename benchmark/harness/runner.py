"""One run of one cell: set-up, the measured window, the traced window, the
comparison with the reference, and the result.

A driver (``drivers/<name>.py``) supplies the cell's program and its items:

* ``setup(ctx) -> state``: weights, inputs and the program, every shape of
  the window warmed up;
* ``step(state, i) -> record``: item i (a batch, a request or a step) as
  the users' code runs it; ``finish(state, records)`` waits for what the
  last items left on the device; an optional ``min_items(state)`` is the
  number of items the window runs at the least, for a comparison that
  follows items inside it;
* ``end_to_end(state, records, window_s) -> {metric: value}`` and
  ``host(records) -> {name: [values]}`` for the per-layer readers;
* ``spans(state)``: the (owner, attribute, layer) the traced window wraps;
* ``work(state) -> {name: number}``: the cell's work from its shapes;
* ``free(state)`` drops the program, and ``readings(state, records, ctx)``
  compares what the window produced with the reference;
* a cell over several cards also gives ``traced_window(state, n, device,
  step)`` and ``memory_peak(state)``, which take in its other ranks.
"""

from __future__ import annotations

import gc
import random
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from . import contract, program, spans, trace
from .spec import Cell, driver, metric_reader


@dataclass
class Context:
    cell: Cell
    seed: int
    device: torch.device
    cfg: Any
    gen: torch.Generator
    rng: random.Random
    shrink: Optional[Tuple[int, int]] = None


@dataclass
class Readout:
    """What a per-layer reader sees."""
    device: torch.device
    trace: Optional[trace.Trace]
    host: Dict[str, List[float]]
    work: Dict[str, float]


def device_info(drv, state, device: torch.device, chips: int) -> Dict:
    """The card, and the peak memory of the fullest one."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    peak = (drv.memory_peak(state) if hasattr(drv, "memory_peak")
            else torch.cuda.max_memory_allocated(device))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(peak)}


def prepare(cell: Cell, seed: int, device, shrink: Optional[Tuple[int, int]] = None):
    """(driver, context, state): the cell set up from ``seed``. ``shrink``
    (image size, inner steps) is for the CPU tests."""
    device = torch.device(device)
    program.tf32_off()
    drv = driver(cell)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    ctx = Context(cell=cell, seed=seed, device=device, cfg=program.port_cfg(cell.config, shrink),
                  gen=gen, rng=random.Random(seed), shrink=shrink)
    state = drv.setup(ctx)
    program.sync(device)
    # the objects of the imports and of set-up leave the collector's scans: a
    # full collection inside the window stalls the host for a few hundred ms
    gc.collect()
    gc.freeze()
    return drv, ctx, state


def window(drv, state, seconds: float, device) -> Tuple[List, float]:
    """(records, window seconds): items back to back for ``seconds``, the
    window closing when the last item's work is done."""
    records: List = []
    least = drv.min_items(state) if hasattr(drv, "min_items") else 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds or len(records) < least:
        records.append(drv.step(state, len(records)))
    drv.finish(state, records)
    program.sync(device)
    return records, time.perf_counter() - t0


def run(cell: Cell, seed: int, seconds: float, traced: bool, t_start: float,
        device="cuda", shrink: Optional[Tuple[int, int]] = None) -> Tuple[Dict, List[str]]:
    """(result, forbidden modules found); the set-up counted from ``t_start``."""
    drv, ctx, state = prepare(cell, seed, device, shrink)
    device = ctx.device
    setup_s = time.perf_counter() - t_start
    records, window_s = window(drv, state, seconds, device)

    metrics: Dict[str, Dict] = {}
    device_fields = {}
    breakdown = None
    if traced:
        n = int(cell.traffic["trace_items"])
        offset = len(records)
        extra: List = []
        traced_window = getattr(drv, "traced_window", trace.traced_window)
        with spans.wrapped(drv.spans(state)):
            tr = traced_window(state, n, device,
                               lambda i: extra.append(drv.step(state, offset + i)))
        drv.finish(state, extra)
        records += extra
        view = Readout(device=device, trace=tr,
                       host=drv.host(records[:offset]), work=drv.work(state))
        for m in cell.per_layer:
            value = metric_reader(cell, m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        if device.type == "cuda":
            device_fields = {"busy_s": tr.busy_s, "window_s": tr.window_s}
            breakdown = tr.breakdown()
    else:
        e2e = drv.end_to_end(state, records, window_s)
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}

    info = device_info(drv, state, device, cell.chips)
    info.update(device_fields)
    found = contract.forbidden_modules()
    drv.free(state)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = contract.judged(drv.readings(state, records, ctx), cell.limits)
    result = {"correct": contract.is_correct(checks), "attempted": len(records),
              "failed": 0, "metrics": metrics, "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, found
