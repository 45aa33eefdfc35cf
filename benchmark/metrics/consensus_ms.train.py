"""Device ms per step of the operations launched inside the program's
consensus spans (fss/consensus: models/matching.py NeighConsensus,
models/conv4d.py CenterPivotConv4d, the pivot operator's backward in
ops/cuda_pivot.py), in the traced window."""

from benchmark.harness import program_readers


def read(view):
    return program_readers.device_ms_within(view, ("fss/consensus",))
