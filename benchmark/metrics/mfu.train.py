"""The cell's model FLOPs (the reference's, counted at the cell's shapes) over
fp32's peak and the traced window, in percent."""

from benchmark.harness import readers


def read(view):
    return readers.mfu_pct(view)
