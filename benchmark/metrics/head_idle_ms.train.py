"""Device idle ms per step while the host is inside the MMN head's forward
or backward (fss/head_forward, fss/head_backward: episodic/heads.py), in the
traced window."""

from benchmark.harness import program_readers


def read(view):
    return program_readers.idle_ms_within(view, ("fss/head_forward", "fss/head_backward"))
