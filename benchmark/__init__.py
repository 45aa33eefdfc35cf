"""The benchmark of ``few_shot_seg_cwt_tpu_torch`` on the H100: ``run.py``
runs one cell of ``BENCHMARK.json``."""
