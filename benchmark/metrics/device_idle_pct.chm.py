"""The share of the traced window in which no operation ran on the device, in percent."""

from benchmark.harness import readers


def read(view):
    return readers.idle_pct(view)
