"""The bound of a step's centre-pivot calls (forward, input and weight
gradients; work.pivot_work) over the device time of the pivot kernels, found
by name (ops/cuda_pivot.py, csrc/pivot.cu), in percent."""

from benchmark.harness import readers


def read(view):
    return readers.kernels_roofline_pct(view, lambda name: "pivot" in name, "consensus_bound_ms")
