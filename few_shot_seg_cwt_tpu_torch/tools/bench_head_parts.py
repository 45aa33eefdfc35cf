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
  pivot_<ci>to<co>_<route>_fwd / _grad
                          one CenterPivotConv4d block (2->10, 10->10,
                          10->1, 1->10) on the flat route (the hand-written
                          ``pivot_fwd`` / ``pivot_dw`` operators) and on the
                          rank-4 route (cuDNN plane convs on (B, Q, S, C)),
                          forward and forward + backward
  match_pipeline_fwd / _grad[<route>]
                          mutual matching -> symmetric NeighConsensus
                          (1->10->10->1) -> mutual matching, on each route
  readout, readout_vjp    softmax(corr * temp) @ v, forward and + backward

Each part's time is the median of ``reps`` calls after a warm-up, each call
bracketed by CUDA events on the current stream: the device's own time for
the part. TF32 is off, as in every entry point of the port. The JAX tool
instead ran K- and 2K-step ``lax.scan`` chains and took the slope, which
was what survived the TPU host's per-call transport floor; the card has no
such floor, so one call is one measurement here.
The CHM parts of the JAX tool wait for the CHM head (ROADMAP queue 1 item 8).

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

from ..models.conv4d import CenterPivotConv4d
from ..models.matching import NeighConsensus
from ..models.msm import WeightAverage
from ..ops.corr import get_corr, masked_attention_readout, mutual_matching_flat
from ..train.common import fp32_parity
from .profile_inner_loop import cuda_ms
from .roofline import card_line

CHAIN = "cuda-events"


def _route(flat: bool) -> None:
    if flat:
        os.environ["FSS_PIVOT_MXU"] = "1"
    else:
        os.environ.pop("FSS_PIVOT_MXU", None)


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
    for var in ("FSS_PIVOT_PALLAS", "FSS_DISABLE_PALLAS", "FSS_NCONS_R4"):
        os.environ.pop(var, None)

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
        x_bqsc = x.permute(0, 2, 3, 1).contiguous()
        for route, flat in (("flat", True), ("r4", False)):
            _route(flat)
            if flat:
                fwd = lambda t: blk(t, fuse_relu=True, flat_dims=dims)  # noqa: E731
                inp = x
            else:
                fwd = lambda t: blk(t, fuse_relu=True, flat_dims=dims, bqsc=True)  # noqa: E731
                inp = x_bqsc
            with torch.no_grad():
                rec(f"pivot_{ci}to{co}_{route}_fwd", lambda: fwd(inp))
            rec(f"pivot_{ci}to{co}_{route}_grad", grad_of(fwd, inp))
        del x, x_bqsc

    corr = rand(1, 1, q, s).abs()
    for route, flat in (("flat", True), ("r4", False)):
        _route(flat)
        ncons = NeighConsensus(in_channel=1, block_remat=False).to(dev, dt)
        if flat:
            def pipeline(t):
                return mutual_matching_flat(ncons(mutual_matching_flat(t), flat_dims=dims))
        else:
            def pipeline(t):
                x4 = mutual_matching_flat(t).permute(0, 2, 3, 1)
                return mutual_matching_flat(ncons.bqsc(x4, dims).permute(0, 3, 1, 2))
        with torch.no_grad():
            rec(f"match_pipeline_fwd[{route}]", lambda: pipeline(corr))
        rec(f"match_pipeline_grad[{route}]", grad_of(pipeline, corr))
    _route(False)
    del corr

    corr2d, v = rand(1, q, s), rand(1, s, 512)
    with torch.no_grad():
        rec("readout", lambda: masked_attention_readout(corr2d, v))
    rec("readout_vjp", grad_of(masked_attention_readout, corr2d, v))
    print(card_line(), flush=True)
    return results


if __name__ == "__main__":
    main()
