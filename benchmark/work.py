"""The yardstick's arithmetic: the card's peaks, the work of the hand-written
kernels from their shapes, roofline bounds, and the model's FLOPs counted
over the benchmark's own plain reference.

Peaks are NVIDIA's data sheet for one H100 SXM (dense rates, at its full
700 W power limit). A kernel's bound is the least time the card could take
for its work: the larger of the bytes it must move (each input read once,
each output written once) over the memory rate, and its operations over
the peak rate. Nothing here reads the program: the work follows from the
shapes of the cell, so a kernel that a later change replaces keeps its
count.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def interp_nonzeros(out_size: int, in_size: int) -> int:
    """Non-zeros of the (out, in) align-corners bilinear matrix: two taps a
    row, one where the source sample lands on an input sample."""
    if in_size == 1 or out_size == 1:
        return out_size
    scale = (in_size - 1) / (out_size - 1)
    src = np.arange(out_size, dtype=np.float64) * scale
    lo = np.floor(src)
    hi = np.minimum(lo + 1, in_size - 1)
    return int(np.sum(np.where((src - lo > 0) & (hi != lo), 2, 1)))


def inner_loop_work(e, shot, h, w, c, big_h, big_w, steps) -> Tuple[int, int]:
    """(flops, bytes) of the binary inner loop over ``e`` episodes, each
    input read once and the output written once. Per shot and step: d = f.u
    and acc += G.f (2hwC FLOP each); T = d B^T, D = A T, gB = g B and G =
    A^T gB counted by the non-zeros of the align-corners matrices A (H, h)
    and B (W, w); g = pw sigma(D) - pwy as 5 ops per pixel."""
    nnz_a = interp_nonzeros(big_h, h)
    nnz_b = interp_nonzeros(big_w, w)
    per_step = (2 * 2 * h * w * c + 2 * h * nnz_b + 2 * nnz_a * big_w
                + 5 * big_h * big_w + 2 * big_h * nnz_b + 2 * nnz_a * w)
    flops = e * shot * steps * per_step
    nbytes = 4 * (e * shot * h * w * c + 2 * e * shot * big_h * big_w + 2 * e * c)
    return int(flops), int(nbytes)


def pivot_work(ci, co, q, s, b=1) -> Tuple[int, int]:
    """(flops, bytes) of one centre-pivot conv pair call over a batch of
    ``b`` (forward, input gradient or weight gradient alike): 2 FLOP per
    tap, 18 taps per (ci, co, q, s); each input element read once and each
    output element written once, (Ci + Co) * Q * S floats."""
    return b * 2 * 18 * ci * co * q * s, b * 4 * (ci + co) * q * s


def bound(flops, nbytes, tensor_cores=False) -> Tuple[float, str]:
    """(ms, kind): the larger of the bytes over HBM's rate and the operations
    over the fp32 rate. With ``tensor_cores`` the operations may also run
    fp32-accurate on the tensor cores as 3xTF32 (three TF32 products for
    each fp32 one), and the lesser of the two operation times applies."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    if tensor_cores:
        t_ops = min(t_ops, 3 * flops / PEAK_TF32_FLOPS * 1e3)
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def consensus_calls(channels, dims, symmetric=True, episodes=1, train=True):
    """The pivot pair calls of one pass of a centre-pivot stack over
    ``episodes`` volumes: [(ci, co, Q, S)] for the forward, and for training
    the input gradient of every block but the first (its input, the
    correlation of frozen features, needs none) and the weight gradient of
    every block. ``channels`` = (c_in, c_1, ..., c_out); ``symmetric``
    doubles every call (the swapped stack)."""
    hq, wq, hs, ws = dims
    q, s = hq * wq, hs * ws
    blocks = list(zip(channels[:-1], channels[1:]))
    calls = [(ci, co, q, s) for ci, co in blocks]
    if train:
        calls += [(co, ci, q, s) for ci, co in blocks[1:]]
        calls += [(ci, co, q, s) for ci, co in blocks]
    reps = (2 if symmetric else 1) * episodes
    return calls * reps


def consensus_bound_ms(calls) -> float:
    """Sum of the pivot calls' bounds (3xTF32 allowed for the operations)."""
    return sum(bound(*pivot_work(*c), tensor_cores=True)[0] for c in calls)


def counted_flops(fn: Callable[[], object]) -> int:
    """FLOPs of ``fn()`` by ``torch.utils.flop_counter.FlopCounterMode``;
    run it over the reference on the meta device to count without memory
    or time."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def _meta(sd):
    import torch

    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in sd.items()}


def feature_side(size: int) -> int:
    """The backbone's output side at stride 8."""
    return (size - 1) // 8 + 1


def cwt_episode_flops(sd, sd_cwt, e: int, size: int, layers: int, classes: int, dim: int,
                      steps: int) -> int:
    """FLOPs of CWT evaluation or serving of ``e`` one-shot episodes: the
    reference's backbone over 2e images, transformer and both classifiers'
    tails counted on the meta device, plus the closed-form inner loop."""
    import torch

    from .reference import cwt as ref_cwt
    from .reference import pspnet as ref_pspnet

    meta = torch.device("meta")
    sd, sd_cwt = _meta(sd), _meta(sd_cwt)

    def forward():
        feat, _ = ref_pspnet.features(sd, torch.empty((2 * e, size, size, 3), device=meta),
                                      layers)
        w = torch.empty((e, classes, dim), device=meta)
        ref_cwt.predictions(sd_cwt, w, feat[e:], (size, size))

    h = feature_side(size)
    return counted_flops(forward) + inner_loop_work(e, 1, h, h, dim, size, size, steps)[0]


def mmn_step_flops(sd, head, e: int, size: int, layers: int, bids, temp: float,
                   classes: int, dim: int, steps: int) -> int:
    """FLOPs of one MMN training step on ``e`` one-shot episodes: the
    backbone over 2e images and each episode's head loss with its gradient
    in the head's parameters, counted over the reference on the meta device
    (nothing recomputed), plus the closed-form inner loop."""
    import torch

    from .reference import mmn as ref_mmn
    from .reference import pspnet as ref_pspnet

    meta = torch.device("meta")
    sd = _meta(sd)
    params = {k: v.requires_grad_(True) for k, v in _meta(head).items()}

    def step():
        feat, taps = ref_pspnet.features(sd, torch.empty((2 * e, size, size, 3), device=meta),
                                         layers, taps=tuple(bids))
        for i in range(e):
            loss = ref_mmn.episode_loss(
                params, {b: t[e + i:e + i + 1] for b, t in taps.items()},
                {b: t[i:i + 1] for b, t in taps.items()}, feat[i:i + 1],
                torch.empty((classes, dim), device=meta),
                torch.empty((size, size), dtype=torch.int64, device=meta), bids, temp)
            torch.autograd.grad(loss, list(params.values()))

    h = feature_side(size)
    return counted_flops(step) + inner_loop_work(e, 1, h, h, dim, size, size, steps)[0]
