"""Device ms per evaluation batch of the operations launched inside the
program's Hough convolution spans (fss/chm6d, fss/chm4d:
models/chm.py CHMLearner, models/conv4d.py conv4d), in the traced window."""

from benchmark.harness import program_readers


def read(view):
    return program_readers.device_ms_within(view, ("fss/chm6d", "fss/chm4d"))
