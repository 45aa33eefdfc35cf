"""The card's peaks and the work of the hand-written kernels, shared by
``chip_smoke.py`` and ``tools/bench.py``.

Peaks are NVIDIA's data sheet for one H100 SXM (dense rates, at its full
700 W power limit): fp32 outside the tensor cores, TF32 and bf16 on them,
HBM3. A kernel's bound is the least time the card could take for its work:
the larger of the bytes it must move (each input read once, each output
written once) over the memory rate and its operations over the peak rate.
"""

from __future__ import annotations

import contextlib
import subprocess
from typing import Dict, Iterator, Tuple

import numpy as np

PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def inner_loop_work(e, shot, h, w, c, big_h, big_w, steps) -> Tuple[int, int]:
    """(flops, bytes) the K1 function needs, each input read once and the
    output written once. Per shot and step: d = f.u and acc += G.f (2hwC
    FLOP each); T = d B^T, D = A T, gB = g B and G = A^T gB counted by the
    non-zeros of the align-corners matrices A (H, h) and B (W, w), two taps
    per row; g = pw sigma(D) - pwy as 5 ops per pixel (exp, add, divide,
    multiply, subtract)."""
    from ..ops.resize import interp_matrix_align_corners
    nnz_a = np.count_nonzero(interp_matrix_align_corners(big_h, h))
    nnz_b = np.count_nonzero(interp_matrix_align_corners(big_w, w))
    per_step = (2 * 2 * h * w * c + 2 * h * nnz_b + 2 * nnz_a * big_w
                + 5 * big_h * big_w + 2 * big_h * nnz_b + 2 * nnz_a * w)
    flops = e * shot * steps * per_step
    nbytes = 4 * (e * shot * h * w * c + 2 * e * shot * big_h * big_w + 2 * e * c)
    return int(flops), int(nbytes)


def pivot_work(ci, co, q, s, b=1) -> Tuple[int, int]:
    """(flops, bytes) of one pivot pair call over a batch of ``b``, or of its
    weight gradient: 2 FLOP per tap, 18 taps per (ci, co, q, s); each input
    element read once and each output element written once, (Ci + Co) * Q
    * S floats (the weights and the 18*Ci*Co + Co dW outputs add under
    8 KB)."""
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


@contextlib.contextmanager
def kernel_work() -> Iterator[Dict]:
    """Within the block, tally the operations and bytes of every launch of a
    hand-written kernel (K1/K2, ``pivot_fwd``, ``pivot_dw``), reckoned from
    its arguments by ``inner_loop_work`` and ``pivot_work``: yields
    ``{"flops", "bytes", "launches": {name: n}}``, filled as kernels launch.
    ``torch.utils.flop_counter`` cannot see these kernels; CPU tensors run
    their plain versions, which launch nothing and which it does count."""
    from ..ops import cuda_inner_loop, cuda_pivot

    tally: Dict = {"flops": 0, "bytes": 0, "launches": {}}

    def add(name: str, work: Tuple[int, int]) -> None:
        tally["flops"] += work[0]
        tally["bytes"] += work[1]
        tally["launches"][name] = tally["launches"].get(name, 0) + 1

    launch, launch_fwd, launch_dw = (cuda_inner_loop.launch, cuda_pivot.launch_fwd,
                                     cuda_pivot.launch_dw)

    def loop(lib, f_s, pw, pwy, u0, num_steps, lr, tile=1, plan=None):
        add("adapt_binary" if tile == 1 else "adapt_binary_tiled",
            inner_loop_work(*f_s.shape, *pw.shape[-2:], num_steps))
        return launch(lib, f_s, pw, pwy, u0, num_steps, lr, tile, plan)

    def fwd(lib, x, wa, wb, bias, dims, relu=False):
        add("pivot_fwd", pivot_work(x.shape[1], wa.shape[-1], dims[0] * dims[1],
                                    dims[2] * dims[3], x.shape[0]))
        return launch_fwd(lib, x, wa, wb, bias, dims, relu)

    def dw(lib, x, g, dims):
        add("pivot_dw", pivot_work(x.shape[1], g.shape[1], dims[0] * dims[1],
                                   dims[2] * dims[3], x.shape[0]))
        return launch_dw(lib, x, g, dims)

    cuda_inner_loop.launch, cuda_pivot.launch_fwd, cuda_pivot.launch_dw = loop, fwd, dw
    try:
        yield tally
    finally:
        cuda_inner_loop.launch, cuda_pivot.launch_fwd, cuda_pivot.launch_dw = (
            launch, launch_fwd, launch_dw)
