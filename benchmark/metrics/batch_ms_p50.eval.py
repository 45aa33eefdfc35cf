"""The median host time of an evaluation batch in the measured window, from one
batch's metrics on the host to the next's (engine layer,
episodic/engine.py)."""

from benchmark.harness import readers


def read(view):
    return readers.host_median_ms(view)
