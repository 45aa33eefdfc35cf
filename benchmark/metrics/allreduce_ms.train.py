"""Device ms under the span around the program's gradient all-reduce
(parallel/mesh.py all_reduce_grads, NCCL) per step on rank 0, in the traced
window: the exchange and the wait for the slowest rank."""

from benchmark.harness import readers


def read(view):
    return readers.span_ms_per_call(view, "allreduce")
