"""Host ms per request inside the program's staging (fss/stage:
episodic/engine.py to_device, pick_w0: the request's host arrays and the
classifier's init to the card), in the traced window."""

from benchmark.harness import program_readers


def read(view):
    return program_readers.host_ms_within(view, ("fss/stage",))
