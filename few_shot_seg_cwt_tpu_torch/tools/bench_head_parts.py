"""Decomposition microbenchmark for the MMN / match head's hot path, on the
card.

The port's counterpart of the repository root's ``tools/bench_head_parts.py``
(the JAX tool). It times each stage of the extension-head programs at the
473 px feature grid (60 x 60, ``PARTS_FEAT``):

  corr_1024 / corr_2048   the 3600 x 3600 cosine-correlation matmuls
  wa_1024                 WeightAverage local attention on stage features
  mm_vol10, mm_vjp_vol10  mutual matching on the flat (1, 10, Q, S) volume,
                          forward and forward + backward wrt its input
  swap_vol10              one whole-volume plane swap (symmetric mode)
  pivot_<ci>to<co>_fwd / _grad
                          one CenterPivotConv4d block (2->10, 10->10,
                          10->1, 1->10) on the flat volume (the hand-written
                          ``pivot_fwd`` / ``pivot_dw`` operators), forward
                          and forward + backward
  match_pipeline_fwd / _grad
                          mutual matching -> symmetric NeighConsensus
                          (1->10->10->1) -> mutual matching
  chm6d_conv_fwd / _grad, chm4d_conv_fwd / _grad
                          the CHM head's two true 4D convs (``conv4d``) at
                          its shapes: (1, 30, 30, 30, 30, 9) through the
                          (5, 5, 5, 5, 9, 9) kernel and (1, 60, 60, 60, 60, 1)
                          through (5, 5, 5, 5, 1, 1) (the forward on
                          ``hough4d``); the gradient is wrt the kernel and
                          the input
  chm_glue, chm_glue_vjp  sigmoid -> scale max-pool -> interpolate4d to 60,
                          the CHM steps between the two convs
  chm_mutual_nn           softplus -> the (1, 3600, 3600) mutual filter
  readout, readout_vjp    softmax(corr * temp) @ v, forward and + backward

Each part's time is the median of ``reps`` calls after a warm-up, each call
bracketed by CUDA events on the current stream: the device's own time for
the part. TF32 is off, as in every entry point of the port. The JAX tool
instead ran K- and 2K-step ``lax.scan`` chains and took the slope, which
was what survived the TPU host's per-call transport floor; the card has no
such floor, so one call is one measurement here.

Usage: python -m few_shot_seg_cwt_tpu_torch.tools.bench_head_parts [fp32|bf16] [reps]
Prints one JSON line per part: {"part", "ms", "dtype", "chain"}, then the
card's name and power limit. ``PARTS_FILTER=substr[,substr...]`` runs only
the matching parts.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Callable, Dict, List

import torch

from ..models.chm import interpolate4d
from ..models.conv4d import CenterPivotConv4d, conv4d
from ..models.matching import NeighConsensus
from ..models.msm import WeightAverage
from ..ops.corr import get_corr, masked_attention_readout, mutual_matching_flat, mutual_nn_filter
from ..train.common import fp32_parity
from .profile_inner_loop import cuda_ms
from .roofline import card_line

CHAIN = "cuda-events"


def main(argv: List[str] = None) -> List[Dict]:
    argv = sys.argv[1:] if argv is None else argv
    dtype_arg = argv[0] if argv else "fp32"
    reps = int(argv[1]) if len(argv) > 1 else 5
    fp32_parity()
    dt = torch.bfloat16 if dtype_arg in ("bf16", "bfloat16") else torch.float32
    h = int(os.environ.get("PARTS_FEAT", "60"))
    dims = (h, h, h, h)
    q = s = h * h
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    filters = [f for f in os.environ.get("PARTS_FILTER", "").split(",") if f]
    results: List[Dict] = []

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    def rec(part: str, fn: Callable) -> None:
        if filters and not any(f in part for f in filters):
            return
        results.append({"part": part, "ms": round(cuda_ms(fn, reps), 3), "dtype": dtype_arg,
                        "chain": CHAIN})
        print(json.dumps(results[-1]), flush=True)

    def grad_of(fn: Callable, *leaves) -> Callable:
        def run():
            xs = [t.detach().requires_grad_(True) for t in leaves]
            fn(*xs).float().sum().backward()
        return run

    with torch.no_grad():
        for c in (1024, 2048):
            f1, f2 = rand(1, h, h, c), rand(1, h, h, c)
            rec(f"corr_{c}", lambda: get_corr(f1, f2))
        wa = WeightAverage(1024).to(dev, dt).eval()
        x1024 = rand(1, h, h, 1024)
        rec("wa_1024", lambda: wa(x1024))
    vol10 = rand(1, 10, q, s).abs()
    with torch.no_grad():
        rec("mm_vol10", lambda: mutual_matching_flat(vol10))
        rec("swap_vol10", lambda: vol10.transpose(2, 3).contiguous())
    rec("mm_vjp_vol10", grad_of(mutual_matching_flat, vol10))
    del vol10

    for ci, co in ((2, 10), (10, 10), (10, 1), (1, 10)):
        blk = CenterPivotConv4d(ci, co).to(dev, dt)
        x = rand(1, ci, q, s)

        def fwd(t):
            return blk(t, fuse_relu=True, flat_dims=dims)
        with torch.no_grad():
            rec(f"pivot_{ci}to{co}_fwd", lambda: fwd(x))
        rec(f"pivot_{ci}to{co}_grad", grad_of(fwd, x))
        del x

    corr = rand(1, 1, q, s).abs()
    ncons = NeighConsensus(in_channel=1, block_remat=False).to(dev, dt)

    def pipeline(t):
        return mutual_matching_flat(ncons(mutual_matching_flat(t), flat_dims=dims))
    with torch.no_grad():
        rec("match_pipeline_fwd", lambda: pipeline(corr))
    rec("match_pipeline_grad", grad_of(pipeline, corr))
    del corr

    hh = h // 2
    k6, k4 = rand(5, 5, 5, 5, 9, 9) * 0.02, rand(5, 5, 5, 5, 1, 1) * 0.02
    x6, x4 = rand(1, hh, hh, hh, hh, 9).abs(), rand(1, h, h, h, h, 1).abs()
    for name, x, k in (("chm6d", x6, k6), ("chm4d", x4, k4)):
        with torch.no_grad():
            rec(f"{name}_conv_fwd", lambda: conv4d(x, k))
        rec(f"{name}_conv_grad", grad_of(conv4d, x, k))
    del x4, x6

    def chm_glue(t):
        y = torch.amax(torch.sigmoid(t).reshape(1, 9, hh, hh, hh, hh), dim=1)
        return interpolate4d(y, h)

    vol6 = rand(1, 3, 3, hh, hh, hh, hh)
    with torch.no_grad():
        rec("chm_glue", lambda: chm_glue(vol6))
    rec("chm_glue_vjp", grad_of(chm_glue, vol6))
    del vol6
    corr2d = rand(1, q, s)
    with torch.no_grad():
        rec("chm_mutual_nn", lambda: mutual_nn_filter(torch.nn.functional.softplus(corr2d)))

    corr2d, v = rand(1, q, s), rand(1, s, 512)
    with torch.no_grad():
        rec("readout", lambda: masked_attention_readout(corr2d, v))
    rec("readout_vjp", grad_of(masked_attention_readout, corr2d, v))
    print(card_line(), flush=True)
    return results


if __name__ == "__main__":
    main()
