"""The inner loop's bound (work.inner_loop_work at the cell's shapes) over the
device time under its span (episodic/inner_loop.py ->
ops/cuda_inner_loop.py, csrc/inner_loop.cu), in percent."""

from benchmark.harness import readers


def read(view):
    return readers.span_roofline_pct(view, "inner_loop", "k1_bound_ms")
