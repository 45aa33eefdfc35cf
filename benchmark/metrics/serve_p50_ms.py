"""The median latency of a served request in the measured window (engine layer,
episodic/engine.py serve_batch)."""

from benchmark.harness import readers


def read(view):
    return readers.host_median_ms(view)
