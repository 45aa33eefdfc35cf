"""The cell's model FLOPs (chm_work.eval_flops: the reference's, counted at
the cell's shapes, the Hough convolutions over the taps inside the volume)
over fp32's peak and the traced window, in percent."""

from benchmark.harness import readers


def read(view):
    return readers.mfu_pct(view)
