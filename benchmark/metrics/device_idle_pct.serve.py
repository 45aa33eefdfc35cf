"""The share of the traced requests' service time, from each one's host
arrays to its mask in host memory, in which no operation ran on the device,
in percent: the pacing's slack between requests is left out."""

from benchmark.harness import readers


def read(view):
    return readers.service_idle_pct(view, "request")
