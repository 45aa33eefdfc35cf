"""The faults of cwt-eval-b8: an answer altered, half the batch left out."""

from benchmark.harness.faults import eval_answer_altered, eval_half_batch

FAULTS = [eval_answer_altered, eval_half_batch]
