"""Time the centre-pivot weight gradient ``pivot_dw`` on the card.

    python -m few_shot_seg_cwt_tpu_torch.tools.profile_pivot [--reps 10]

At 473 px (60x60 query and support planes, one batch element), for each
NeighConsensus block of the MMN head (Ci->Co 2->10, 10->10, 10->1), it
prints ``pivot_dw``'s time and its plain version's (two cuDNN
weight-gradient calls, TF32 off) by CUDA events (median after a warm-up),
their ratio, the grid and shared memory of the launch, and the largest
difference between the two. With ``--phases`` it also builds the kernel
with ``-DFSS_PHASE_CLOCKS`` (thread 0 of each CTA adds the cycles of each
phase of a step, up to the barrier that closes it) and prints the cycles a
step and CTA per phase: issuing the next step's copies, waiting for this
step's, splitting them into TF32 parts, the MMAs, staging a fresh run.
Run it in two trees in one call (parent, change, change, parent) to compare
two versions of the kernel on one card. The last line is one JSON object
with all of it. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from ..ops import cuda_pivot
from ..train.common import fp32_parity
from .profile_inner_loop import cuda_ms

BLOCKS = ((2, 10), (10, 10), (10, 1))
DIMS = (60, 60, 60, 60)
PHASE_DEFINES = ("-DFSS_PHASE_CLOCKS",)
PHASES = ("issue next copies", "wait for copies", "split TF32", "MMAs",
          "stage fresh run")


def phase_cycles(x, g, reps: int):
    """Cycles a step and CTA per phase, from the instrumented build; and
    whether it gives the main build's bits."""
    lib = cuda_pivot.load_library(PHASE_DEFINES)
    lib.fss_pivot_dw_phase_cycles.argtypes = [np.ctypeslib.ndpointer(np.uint64)]
    lib.fss_pivot_dw_phase_cycles.restype = ctypes.c_int
    cycles = np.zeros(len(PHASES), dtype=np.uint64)
    same = all(torch.equal(a, b) for a, b in zip(cuda_pivot.launch_dw(lib, x, g, DIMS),
                                                 cuda_pivot.pivot_dw(x, g, DIMS)))
    torch.cuda.synchronize()
    if lib.fss_pivot_dw_phase_cycles(cycles) != 0:  # read and zero
        raise RuntimeError("fss_pivot_dw_phase_cycles failed")
    ms = cuda_ms(lambda: cuda_pivot.launch_dw(lib, x, g, DIMS), reps, warmup=0)
    if lib.fss_pivot_dw_phase_cycles(cycles) != 0:
        raise RuntimeError("fss_pivot_dw_phase_cycles failed")
    # the CTAs' sums over all steps of a launch: a step's cycles in the CTA
    # that ran it
    steps = DIMS[0] * ((DIMS[2] + 1) // 2) * DIMS[1]          # qi, tile, qj
    per_step = cycles.astype(np.float64) / reps / steps
    total = per_step.sum()
    return {"ms_with_clocks": ms, "same_bits": same,
            "cycles_per_step_and_cta": {n: float(c) for n, c in zip(PHASES, per_step)},
            "share": {n: float(c / total) for n, c in zip(PHASES, per_step)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--phases", action="store_true", help="also the per-phase cycles")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_pivot: needs a CUDA device", file=sys.stderr)
        return 1
    fp32_parity()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    lib = cuda_pivot.load_library()
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    q = s = DIMS[0] * DIMS[1]
    rows = []
    for ci, co in BLOCKS:
        x = torch.tensor(rng.standard_normal((1, ci, q, s), dtype=np.float32), device=dev)
        g = torch.tensor(rng.standard_normal((1, co, q, s), dtype=np.float32), device=dev)
        got = cuda_pivot.pivot_dw(x, g, DIMS)
        want = cuda_pivot.pivot_dw_reference(x, g, DIMS)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        ms = cuda_ms(lambda: cuda_pivot.pivot_dw(x, g, DIMS), args.reps)
        plain_ms = cuda_ms(lambda: cuda_pivot.pivot_dw_reference(x, g, DIMS), args.reps)
        with torch.cuda.device(dev):
            grid = lib.fss_pivot_dw_blocks(1, ci, co, *DIMS)
        row = {"block": f"{ci}->{co}", "ms": ms, "plain_ms": plain_ms,
               "ratio": ms / plain_ms, "grid": grid,
               "smem": lib.fss_pivot_dw_smem_bytes(ci, co, DIMS[3]),
               "max_abs_diff_vs_plain": err}
        print(f"pivot_dw {ci}->{co}: {ms:.3f} ms, plain (cuDNN wgrad) {plain_ms:.3f} ms, "
              f"ratio {ms / plain_ms:.3f}; grid {grid}, {row['smem']} B shared; "
              f"max|dw - dw_plain| {err:.3e} [{card}]")
        if args.phases:
            row["phases"] = phase_cycles(x, g, args.reps)
            print(f"pivot_dw {ci}->{co} phases (cycles a step and CTA, share): " + "; ".join(
                f"{n} {c:.0f} ({row['phases']['share'][n]:.1%})"
                for n, c in row["phases"]["cycles_per_step_and_cta"].items())
                + f"; {row['phases']['ms_with_clocks']:.3f} ms with clocks, same bits "
                f"{row['phases']['same_bits']}")
        rows.append(row)
        del x, g
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "pivot_dw": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
