"""A request's model FLOPs (the reference's, counted at the cell's shapes)
over fp32's peak and the request's service time, from its host arrays to
its mask in host memory, summed over the traced requests, in percent. The
client's pacing sets the window's length, so the window is not the
denominator here."""

from benchmark.harness import readers


def read(view):
    return readers.service_mfu_pct(view, "request")
