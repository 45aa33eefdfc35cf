"""Device ms under the backbone's span (models/resnet.py, models/pspnet.py:
extract_features) per call, in the traced window."""

from benchmark.harness import readers


def read(view):
    return readers.span_ms_per_call(view, "backbone")
