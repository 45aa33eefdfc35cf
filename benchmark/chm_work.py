"""The work of the CHM head's evaluation from its shapes: the Hough
convolutions' operations and bytes, their roofline bound, and the FLOPs of
an evaluation batch (the reference's, counted on the meta device, with the
Hough convolutions counted here).

A 4D convolution's operations are counted over the kernel taps that fall
inside the volume: with zero padding, a tap that reads the padding adds
nothing, and a route or kernel that skips it does the same work. So CHM6d
counts its 49 non-zero (input, output) scale-pair links of the 3 x 3 scale
grid, each 5^4 taps over 30^4 positions at 473 px, less the padded taps,
and CHM4d 5^4 taps over 60^4 positions, less the padded taps. Bytes: each
input element read once and each output element written once.
"""

from __future__ import annotations

from typing import Dict, Tuple

from . import work as W
from .reference import chm as ref_chm

KSZ = ref_chm.KSZ4D
N_SCALES = len(ref_chm.SCALES)


def taps_inside(side: int, k: int) -> int:
    """(output, tap) pairs along one axis of length ``side`` whose input lies
    inside it, for a kernel of odd size ``k`` with zero padding k // 2."""
    r = k // 2
    return sum(min(side - 1, o + r) - max(0, o - r) + 1 for o in range(side))


def hough_work(side: int) -> Dict[str, Tuple[int, int]]:
    """{"chm6d", "chm4d": (flops, bytes)} of one episode, ``side`` the halved
    tap's (30 at 473 px): 2 FLOP a multiply-add."""
    links = taps_inside(N_SCALES, ref_chm.KSZ6D) ** 2
    up = 2 * side
    return {"chm6d": (2 * links * taps_inside(side, KSZ) ** 4,
                      4 * 2 * N_SCALES ** 2 * side ** 4),
            "chm4d": (2 * taps_inside(up, KSZ) ** 4, 4 * 2 * up ** 4)}


def chm_bound_ms(episodes: int, side: int) -> float:
    """The least time of ``episodes`` episodes' CHM6d and CHM4d at fp32's
    peak (TF32 off) and HBM's rate, each convolution bound on its own."""
    return episodes * sum(W.bound(*fb)[0] for fb in hough_work(side).values())


def eval_flops(sd, head, e: int, size: int, layers: int, stage: int, classes: int,
               dim: int, steps: int, att_wt: float, temp: float) -> int:
    """FLOPs of the CHM evaluation of ``e`` one-shot episodes: the backbone
    over 2e images with its stage-``stage`` tap, each episode's scale convs,
    correlations, readout and three classifiers' tails, counted over the
    reference on the meta device; the Hough convolutions of ``hough_work``;
    the closed-form inner loop."""
    import torch

    from .reference import cwt as ref_cwt
    from .reference import pspnet as ref_pspnet

    meta = torch.device("meta")
    sd, head = W._meta(sd), W._meta(head)
    h = W.feature_side(size)
    half = h // 2

    def forward():
        feat, taps = ref_pspnet.features(sd, torch.empty((2 * e, size, size, 3), device=meta),
                                         layers, taps=(stage,))
        c = taps[stage].shape[-1]
        w = torch.empty((1, classes, dim), device=meta)
        for _ in range(e):
            tap = torch.empty((1, half, half, c), device=meta)
            ref_chm.correlation6d(head, tap, tap)
            v = torch.empty((1, h, h, dim), device=meta)
            wv = ref_chm.readout(torch.empty((1,) + (h,) * 4, device=meta), v, temp)
            for f in (wv, (wv * att_wt + v) / (1 + att_wt), v):
                ref_cwt.logits_up(w, f, (size, size))

    hough = sum(f for f, _ in hough_work(half).values())
    return (W.counted_flops(forward) + e * hough
            + W.inner_loop_work(e, 1, h, h, dim, size, size, steps)[0])
