"""The readers of the program's own ``fss/`` spans (``harness/program_readers.py``)
on hand-built traces, and the benchmark's existing readers beside them.

    python -m pytest benchmark/tests/test_program_readers.py -q
"""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import program_readers as pr
from benchmark.harness import readers, runner, trace

# a 100 us window of two items: three operations, each launched 5 us before it starts
OPS = [("k1", 10.0, 20.0, 5.0), ("k2", 30.0, 40.0, 25.0), ("k3", 60.0, 70.0, 55.0)]
PROGRAM = {"fss/eval_batch": [(0.0, 90.0)], "fss/tail": [(20.0, 35.0), (50.0, 65.0)],
           "fss/transform": [(15.0, 25.0)]}
BENCH = {"backbone": [(4.0, 21.0)], "inner_loop": [(24.0, 45.0)], "request": [(0.0, 90.0)]}


def _view(spans, ops=OPS, window_s=100e-6):
    tr = trace.Trace(window_s=window_s, items=2, ops=list(ops), spans=dict(spans))
    return runner.Readout(device=torch.device("cuda"), trace=tr, host={},
                          work={"flops_per_item": 1e6, "k1_bound_ms": 0.001,
                                "consensus_bound_ms": 0.002})


def test_the_union_of_the_tail_and_transform_spans():
    """transform [15, 25] and tail [20, 35], [50, 65]: 35 us of host time
    over two items, 15 us of it busy ([15, 20], [30, 35], [60, 65]); the
    operations launched inside, k2 (at 25) and k3 (at 55), 20 us."""
    view = _view(PROGRAM)
    names = ("fss/transform", "fss/tail")
    assert pr.union(view.trace, names) == [(15.0, 35.0), (50.0, 65.0)]
    assert pr.host_ms_within(view, names) == pytest.approx(35e-3 / 2)
    assert pr.idle_ms_within(view, names) == pytest.approx(20e-3 / 2)
    assert pr.device_ms_within(view, names) == pytest.approx(20e-3 / 2)


def test_a_launch_after_an_inner_span_inside_its_outer_span_counts_once():
    """Nested consensus spans [0, 50] and [10, 30]: k1 (launched at 5) and
    k2 (at 25, inside both) and k3 (at 55, outside) give 20 us, k2 once."""
    view = _view({"fss/consensus": [(0.0, 50.0), (10.0, 30.0)]})
    assert pr.device_ms_within(view, ("fss/consensus",)) == pytest.approx(20e-3 / 2)
    assert pr.host_ms_within(view, ("fss/consensus",)) == pytest.approx(50e-3 / 2)


def test_the_readers_return_nothing_without_the_program_spans_or_a_card():
    view = _view(BENCH)
    for read in (pr.host_ms_within, pr.idle_ms_within, pr.device_ms_within):
        assert read(view, ("fss/tail",)) is None
    cpu = runner.Readout(device=torch.device("cpu"), trace=_view(PROGRAM).trace, host={},
                         work={})
    assert pr.idle_ms_within(cpu, ("fss/tail",)) is None


def test_idle_splits_by_the_innermost_span_and_sums_to_the_window_idle():
    """Idle [0, 10], [20, 30], [40, 60], [70, 100]: eval_batch 10 + 10 + 20,
    transform 5, tail 5 + 10, and 10 after the last span ends."""
    tr = _view(PROGRAM).trace
    split = pr.idle_by_phase(tr, 0.0)
    assert split == pytest.approx({"fss/eval_batch": 40e-6, "fss/transform": 5e-6,
                                   "fss/tail": 15e-6, "no span": 10e-6})
    assert sum(split.values()) == pytest.approx(tr.window_s - tr.busy_s)


def test_the_existing_readers_read_the_same_beside_program_spans():
    """The benchmark's readers key their spans by the benchmark's names, so
    the program's spans in the same trace change none of their readings."""
    alone, beside = _view(BENCH), _view({**BENCH, **PROGRAM})
    for read in (lambda v: readers.span_ms_per_call(v, "backbone"),
                 lambda v: readers.span_roofline_pct(v, "inner_loop", "k1_bound_ms"),
                 lambda v: readers.kernels_roofline_pct(v, lambda n: n == "k3",
                                                        "consensus_bound_ms"),
                 readers.mfu_pct, readers.idle_pct,
                 lambda v: readers.service_mfu_pct(v, "request"),
                 lambda v: readers.service_idle_pct(v, "request")):
        assert read(alone) is not None and read(beside) == read(alone)


def test_parse_keeps_the_benchmark_spans_whatever_the_program_adds():
    """A chrome trace with the program's ``fss/`` ranges beside the
    benchmark's ``bench::`` ones parses to the same benchmark spans and
    operations as one without them."""
    events = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 5.0,
               "dur": 1.0, "args": {"correlation": 1}},
              {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10.0, "dur": 10.0,
               "args": {"correlation": 1}},
              {"ph": "X", "cat": "user_annotation", "name": "bench::backbone", "ts": 4.0,
               "dur": 17.0}]
    program = [{"ph": "X", "cat": "user_annotation", "name": name, "ts": s, "dur": e - s}
               for name, ivs in PROGRAM.items() for s, e in ivs]
    alone = trace.parse(events, 100e-6, 2)
    beside = trace.parse(events + program, 100e-6, 2)
    assert alone.ops == beside.ops == [("k1", 10.0, 20.0, 5.0)]
    assert beside.spans["backbone"] == alone.spans["backbone"] == [(4.0, 21.0)]


def test_parse_keeps_bench_spans_stripped_and_program_spans_whole():
    """``bench::`` spans under their names without the prefix, ``fss/``
    spans under their full names, other annotations (a user's range, the
    device-side copy of a range) dropped; the program's spans then feed
    its readers and name the idle gap before the kernel launched in them."""
    events = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 5.0,
               "dur": 1.0, "args": {"correlation": 1}},
              {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10.0, "dur": 10.0,
               "args": {"correlation": 1}},
              {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 52.0,
               "dur": 1.0, "args": {"correlation": 2}},
              {"ph": "X", "cat": "kernel", "name": "k2", "ts": 60.0, "dur": 10.0,
               "args": {"correlation": 2}},
              {"ph": "X", "cat": "user_annotation", "name": "bench::backbone", "ts": 4.0,
               "dur": 17.0},
              {"ph": "X", "cat": "user_annotation", "name": "fss/tail", "ts": 50.0, "dur": 15.0},
              {"ph": "X", "cat": "user_annotation", "name": "fss/tail", "ts": 20.0, "dur": 15.0},
              {"ph": "X", "cat": "user_annotation", "name": "my_range", "ts": 0.0, "dur": 90.0},
              {"ph": "X", "cat": "gpu_user_annotation", "name": "fss/tail", "ts": 60.0,
               "dur": 10.0},
              {"ph": "i", "cat": "user_annotation", "name": "fss/stage", "ts": 1.0}]
    tr = trace.parse(events, 100e-6, 2)
    assert tr.ops == [("k1", 10.0, 20.0, 5.0), ("k2", 60.0, 70.0, 52.0)]
    assert tr.spans == {"backbone": [(4.0, 21.0)], "fss/tail": [(50.0, 65.0), (20.0, 35.0)]}
    view = runner.Readout(device=torch.device("cuda"), trace=tr, host={}, work={})
    assert pr.device_ms_within(view, ("fss/tail",)) == pytest.approx(10e-3 / 2)
    assert pr.idle_ms_within(view, ("fss/tail",)) == pytest.approx(25e-3 / 2)
    assert readers.span_ms_per_call(view, "backbone") == pytest.approx(10e-3)
    assert tr.breakdown()["idle_gaps"] == [["before k2 (fss/tail)", pytest.approx(40e-6)]]
