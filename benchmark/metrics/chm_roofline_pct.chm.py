"""The bound of a batch's CHM6d and CHM4d (chm_work.chm_bound_ms: taps
inside the volume, fp32 peak, TF32 off) over their device ms a batch
(chm_ms.chm: the operations launched inside fss/chm6d and fss/chm4d), in
percent."""

from benchmark.harness import program_readers


def read(view):
    ms = program_readers.device_ms_within(view, ("fss/chm6d", "fss/chm4d"))
    return 100.0 * view.work["chm_bound_ms"] / ms if ms else None
