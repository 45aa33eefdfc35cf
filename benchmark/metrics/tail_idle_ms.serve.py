"""Device idle ms per request while the host is inside the program's
transform or tail (fss/transform: EpisodicEngine._predict; fss/tail:
mask_from_prediction), in the traced window."""

from benchmark.harness import program_readers


def read(view):
    return program_readers.idle_ms_within(view, ("fss/transform", "fss/tail"))
