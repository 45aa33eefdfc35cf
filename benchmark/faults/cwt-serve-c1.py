"""The faults of cwt-serve-c1: a served mask altered."""

from benchmark.harness.faults import serve_answer_altered

FAULTS = [serve_answer_altered]
