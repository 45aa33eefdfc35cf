"""The CHM head's work (``benchmark/chm_work.py``) pinned at the cell's
shapes and against brute-force counts at small sides: the taps of a 4D
convolution that fall inside the volume, by the reference's own 4D
convolution of ones; the 49 links of the 3 x 3 scale grid, by walking it;
and the bound a batch of ``chm-eval-b4`` reads."""

from __future__ import annotations

import itertools

import pytest
import torch

from benchmark import chm_work
from benchmark import work as W
from benchmark.harness import program
from benchmark.harness.spec import load_cell
from benchmark.harness.weights import make_state
from benchmark.reference import chm as ref_chm
from benchmark.reference import pspnet as ref_pspnet


@pytest.mark.parametrize("side,k", [(1, 5), (3, 5), (4, 5), (6, 5), (7, 3)])
def test_taps_inside_equal_a_convolution_of_ones(side, k):
    """Each output's count of taps inside the volume is the convolution of
    ones with a kernel of ones; their sum is taps_inside(side, k) ** 4."""
    ones = torch.ones((1, 1) + (side,) * 4, dtype=torch.float64)
    got = ref_chm.conv4d(ones, torch.ones((1, 1) + (k,) * 4, dtype=torch.float64))
    assert int(got.sum()) == chm_work.taps_inside(side, k) ** 4


def test_scale_links_by_walking_the_grid():
    """49 (input pair, output pair) links under a 3 x 3 kernel with zero
    padding: a pair's offset in each scale axis is -1, 0 or +1."""
    pairs = list(itertools.product(range(3), repeat=2))
    walked = sum(1 for (a, b), (i, j) in itertools.product(pairs, pairs)
                 if abs(a - i) <= 1 and abs(b - j) <= 1)
    assert walked == len(ref_chm.scale_links()) == chm_work.taps_inside(3, 3) ** 2 == 49


def test_hough_work_and_bound_at_the_cells_shapes():
    """473 px: the tap's side 60, halved to 30; CHM4d at 60. Per axis 144 of
    30 x 5 and 294 of 60 x 5 (output, tap) pairs lie inside."""
    cfg = program.port_cfg(load_cell("chm-eval-b4").config)
    half = W.feature_side(cfg.image_size) // 2
    assert half == 30
    assert chm_work.taps_inside(30, 5) == 144 and chm_work.taps_inside(60, 5) == 294
    work = chm_work.hough_work(half)
    assert work["chm6d"] == (2 * 49 * 144 ** 4, 4 * 2 * 9 * 30 ** 4)
    assert work["chm4d"] == (2 * 294 ** 4, 4 * 2 * 60 ** 4)
    # under the padded count: 49 x 625 taps over 30^4, 625 over 60^4
    assert work["chm6d"][0] < 2 * 49 * 625 * 30 ** 4 and work["chm4d"][0] < 2 * 625 * 60 ** 4
    # both bound by their operations at fp32's 67 TFLOP/s: 3.408 ms a batch of 4
    assert W.bound(*work["chm6d"])[1] == W.bound(*work["chm4d"])[1] == "operations"
    ms = chm_work.chm_bound_ms(4, half)
    assert ms == pytest.approx(4 * (work["chm6d"][0] + work["chm4d"][0]) / 67e12 * 1e3)
    assert ms == pytest.approx(3.4078, abs=1e-4)


def test_eval_flops_count_the_hough_work_once_an_episode():
    """At 41 px (halved side 3) the batch's FLOPs are the meta-device count
    of the rest plus e times the Hough work and the inner loop; an episode
    more adds one episode's work."""
    cfg = program.port_cfg(load_cell("chm-eval-b4").config, (41, 5))
    gen = torch.Generator().manual_seed(5)
    sd = make_state(ref_pspnet.schema(cfg.layers, cfg.bottleneck_dim), gen, "cpu")
    head = make_state(ref_chm.schema(), gen, "cpu")

    def flops(e):
        return chm_work.eval_flops(sd, head, e, 41, cfg.layers, 4, 2, cfg.bottleneck_dim,
                                   5, cfg.att_wt, cfg.temp)

    one, two = flops(1), flops(2)
    hough = sum(f for f, _ in chm_work.hough_work(3).values())
    assert hough > 0 and one > hough + W.inner_loop_work(1, 1, 6, 6, 512, 41, 41, 5)[0]
    assert two - one == pytest.approx(one, rel=1e-9)
