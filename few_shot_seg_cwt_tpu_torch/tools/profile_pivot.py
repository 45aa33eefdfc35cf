"""Time the centre-pivot kernels ``pivot_dw`` and ``pivot_fwd`` on the card.

    python -m few_shot_seg_cwt_tpu_torch.tools.profile_pivot [--reps 10] [--against PATH]
    python -m few_shot_seg_cwt_tpu_torch.tools.profile_pivot --fwd [--against PATH]

At 473 px (60x60 query and support planes, one batch element), for each
NeighConsensus block of the MMN head (Ci->Co 2->10, 10->10, 10->1) and the
match head's first (1->10), it prints ``pivot_dw``'s time and its plain
version's (two cuDNN weight-gradient calls, TF32 off) by CUDA events
(median after a warm-up), their ratio, the time's share of the bound, the
launch (grid, shared memory, support rows a step, column and g slots), and
the largest difference between the two. With ``--phases`` it also builds
the kernel with ``-DFSS_PHASE_CLOCKS`` (one thread of each role adds the
cycles of its phases) and prints the cycles a step and CTA of each: the MMA
warps' wait on a landed stage, the producer's wait on an empty slot, the
producer's issue of its copies, the MMAs with the TF32 split of their
fragments; and the MMA warps' wait as a share of their step (wait + MMAs),
which says how far the copies hide under the MMAs. The two roles run at
once, so the four do not add up to a step.
``--against PATH`` (a ``pivot.cu``, built here with the same flags, or a
built library) also runs that library's ``fss_pivot_dw`` on the same
inputs, in turns with this one (the other, this, this, the other): its
time and the largest difference from this one's values.

With ``--fwd`` it times ``pivot_fwd`` instead, at the six shapes the MMN
path gives it at 473 px: the three blocks' forwards (ReLU on) and their dx
in the backward (flipped, (ci, co)-transposed weights, Ci and Co swapped,
zero bias, no ReLU), against its plain version (two cuDNN conv2d, TF32
off), with each time's share of the bound (the larger of bytes over
3.35 TB/s and the operations at the lesser of fp32 and 3xTF32, as in
``chip_smoke.py``) and of the fp32 FMA floor on the CUDA cores, and the
launch plan; with ``--phases``, its cycles a step and CTA per phase from a
``-DFSS_PHASE_CLOCKS`` build: issuing the next column's copies, waiting for
this step's, computing and storing, staging a fresh run's window.
``--against PATH`` (a ``pivot.cu``, built here with the same flags, or a
built library) also runs that library's ``fss_pivot_fwd`` on the same
inputs, in turns with this one: its time, and whether it gives the same
values (``torch.equal``). The last line is one JSON object with all of it.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import cuda_build, cuda_pivot
from ..train.common import fp32_parity
from .profile_inner_loop import cuda_ms

BLOCKS = ((2, 10), (10, 10), (10, 1), (1, 10))
DIMS = (60, 60, 60, 60)
PHASE_DEFINES = ("-DFSS_PHASE_CLOCKS",)
PHASES = ("consumers' wait", "producer's wait", "producer's issue", "MMAs and split")
FWD_PHASES = ("issue next copies", "wait for copies", "compute and store",
              "stage fresh run")
# pivot_fwd's calls on the MMN path: (name, Ci, Co, the forward's ReLU); a
# dx call is the forward of its block with Ci and Co swapped
FWD_SHAPES = (("fwd 2->10", 2, 10, True), ("fwd 10->10", 10, 10, True),
              ("fwd 10->1", 10, 1, True), ("dx 10->2", 10, 2, False),
              ("dx 10->10", 10, 10, False), ("dx 1->10", 1, 10, False))
# H100 SXM data-sheet peaks, as chip_smoke.py takes them
PEAK_FP32_FLOPS, PEAK_TF32_FLOPS, PEAK_HBM_BYTES = 67e12, 495e12, 3.35e12


def dw_plan(ci: int, co: int) -> dict:
    """pivot_dw's layout at DIMS: support rows a step, column and g slots,
    threads a CTA, shared bytes a CTA."""
    lib = cuda_pivot.load_library()
    lib.fss_pivot_dw_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.fss_pivot_dw_plan.restype = ctypes.c_size_t
    out = (ctypes.c_int * 4)()
    smem = lib.fss_pivot_dw_plan(ci, co, DIMS[3], ctypes.addressof(out))
    return {"rows": out[0], "column_slots": out[1], "g_slots": out[2], "threads": out[3],
            "smem": smem}


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
    rows = dw_plan(x.shape[1], g.shape[1])["rows"]
    steps = x.shape[0] * DIMS[0] * -(-DIMS[2] // rows) * DIMS[1]      # b, qi, tile, qj
    per_step = cycles.astype(np.float64) / reps / steps
    wait, mma = per_step[0], per_step[3]
    return {"ms_with_clocks": ms, "same_bits": same,
            "cycles_per_step_and_cta": {n: float(c) for n, c in zip(PHASES, per_step)},
            "consumers_wait_share": float(wait / (wait + mma))}


def fwd_bounds(ci: int, co: int, q: int, s: int):
    """(bound ms, its kind, fp32 FMA floor ms) of one pivot_fwd call: 2 FLOP
    per tap, 18 taps per (ci, co, q, s); each input read once and the output
    written once."""
    flops, nbytes = 2 * 18 * ci * co * q * s, 4 * (ci + co) * q * s
    fp32 = flops / PEAK_FP32_FLOPS * 1e3
    t_ops = min(fp32, 3 * flops / PEAK_TF32_FLOPS * 1e3)
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations", fp32) if t_ops >= t_bytes else (t_bytes, "bytes", fp32)


def load_against(path: str) -> ctypes.CDLL:
    """A second pivot library: ``path`` is a ``pivot.cu`` (built now with this
    tree's nvcc flags) or a built ``.so``; its ``fss_pivot_fwd``,
    ``fss_pivot_dw`` and ``fss_pivot_dw_blocks`` are bound (the C interface
    every version has had)."""
    src = Path(path)
    if src.suffix == ".cu":
        src = cuda_build.build([(src.resolve(), "libfss_pivot_against", ())])[0]
    lib = ctypes.CDLL(str(src))
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.fss_pivot_fwd.argtypes = [p] * 4 + [i] * 8 + [p]
    lib.fss_pivot_fwd.restype = i
    lib.fss_pivot_dw.argtypes = [p] * 4 + [i] * 8 + [p]
    lib.fss_pivot_dw.restype = i
    lib.fss_pivot_dw_blocks.argtypes = [i] * 7
    lib.fss_pivot_dw_blocks.restype = i
    return lib


def against_dw(against: ctypes.CDLL, x: torch.Tensor, g: torch.Tensor):
    """The second library's pivot_dw on x and g at DIMS: a launch function
    and the buffer its flat (dW, db) lands in."""
    b, ci = x.shape[:2]
    co = g.shape[1]
    with torch.cuda.device(x.device):
        blocks = against.fss_pivot_dw_blocks(b, ci, co, *DIMS)
    if blocks < 1:
        raise RuntimeError("the second library's pivot_dw takes no CTA")
    partial = torch.empty((blocks, 18 * ci * co + co), device=x.device)
    out = torch.empty((18 * ci * co + co,), device=x.device)

    def launch():
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = against.fss_pivot_dw(x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                                   out.data_ptr(), b, ci, co, *DIMS, blocks, stream)
        if err != 0:
            raise RuntimeError(f"the second library's pivot_dw failed ({err})")

    return launch, out


def fwd_plan(x: torch.Tensor, co: int) -> dict:
    """pivot_fwd's launch for x (B, Ci, Q, S) at DIMS on its card: positions
    a thread, support rows a tile, threads a CTA, CTAs, shared bytes a CTA."""
    lib = cuda_pivot.load_library()
    out = (ctypes.c_int * 4)()
    b, ci = x.shape[:2]
    with torch.cuda.device(x.device):
        err = lib.fss_pivot_fwd_plan(b, ci, co, *DIMS, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"fss_pivot_fwd_plan failed ({err})")
    return {"positions": out[0], "rows": out[1], "threads": out[2], "blocks": out[3],
            "smem": lib.fss_pivot_fwd_smem_bytes(ci, co, DIMS[2], DIMS[3])}


def fwd_phase_cycles(x, wa, wb, bias, relu: bool, co: int, reps: int, y):
    """pivot_fwd's cycles a step and CTA per phase, from the instrumented
    build; and whether it gives the main build's values ``y``."""
    lib = cuda_pivot.load_library(PHASE_DEFINES)
    lib.fss_pivot_fwd_phase_cycles.argtypes = [np.ctypeslib.ndpointer(np.uint64)]
    lib.fss_pivot_fwd_phase_cycles.restype = ctypes.c_int
    cycles = np.zeros(len(FWD_PHASES), dtype=np.uint64)
    same = bool(torch.equal(cuda_pivot.launch_fwd(lib, x, wa, wb, bias, DIMS, relu), y))
    torch.cuda.synchronize()
    if lib.fss_pivot_fwd_phase_cycles(cycles) != 0:  # read and zero
        raise RuntimeError("fss_pivot_fwd_phase_cycles failed")
    ms = cuda_ms(lambda: cuda_pivot.launch_fwd(lib, x, wa, wb, bias, DIMS, relu), reps,
                 warmup=0)
    if lib.fss_pivot_fwd_phase_cycles(cycles) != 0:
        raise RuntimeError("fss_pivot_fwd_phase_cycles failed")
    rows = fwd_plan(x, co)["rows"]
    steps = x.shape[0] * DIMS[0] * DIMS[1] * -(-DIMS[2] // rows)   # (b, tile, qi, qj)
    per_step = cycles.astype(np.float64) / reps / steps
    total = per_step.sum()
    return {"ms_with_clocks": ms, "same_bits": same,
            "cycles_per_step_and_cta": {n: float(c) for n, c in zip(FWD_PHASES, per_step)},
            "share": {n: float(c / total) for n, c in zip(FWD_PHASES, per_step)}}


def profile_fwd(reps: int, card: str, against, phases: bool = False) -> list:
    """pivot_fwd at FWD_SHAPES: time, plain time, bound shares, plan, and the
    second library's time and equality where there is one."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    q = s = DIMS[0] * DIMS[1]
    rows = []
    for name, ci, co, relu in FWD_SHAPES:
        x = torch.tensor(rng.standard_normal((1, ci, q, s), dtype=np.float32), device=dev)
        if relu:
            w = (rng.standard_normal((2, 3, 3, ci, co)) / np.sqrt(18 * ci)).astype(np.float32)
            wa, wb = (torch.tensor(a, device=dev) for a in w)
            bias = torch.tensor(rng.standard_normal(co, dtype=np.float32), device=dev)
        else:   # dx of the block co -> ci: its weights flipped and transposed
            w = (rng.standard_normal((2, 3, 3, co, ci)) / np.sqrt(18 * co)).astype(np.float32)
            wa, wb = (cuda_pivot.flip_t(torch.tensor(a, device=dev)) for a in w)
            bias = torch.zeros(co, device=dev)
        fwd = lambda: cuda_pivot.pivot_fwd(x, wa, wb, bias, DIMS, relu)  # noqa: E731
        plain = lambda: cuda_pivot.pivot_conv_flat_reference(  # noqa: E731
            x, wa, wb, bias, DIMS, relu)
        y = fwd()
        err = float((y - plain()).abs().max())
        b_ms, b_by, fp32_ms = fwd_bounds(ci, co, q, s)
        row = {"call": name, "ci": ci, "co": co, "bound_ms": b_ms, "bound_by": b_by,
               "fp32_floor_ms": fp32_ms, "max_abs_diff_vs_plain": err,
               "scale": float(y.abs().max()), "plan": fwd_plan(x, co)}
        if against is None:
            row["ms_runs"] = [cuda_ms(fwd, reps)]
        else:   # in turns: the second library, this one, this one, the second
            wf = cuda_pivot.flatten_weights(wa, wb)
            y2 = torch.empty_like(y)

            def other():
                stream = torch.cuda.current_stream(dev).cuda_stream
                err = against.fss_pivot_fwd(x.data_ptr(), wf.data_ptr(), bias.data_ptr(),
                                            y2.data_ptr(), 1, ci, co, *DIMS, int(relu), stream)
                if err != 0:
                    raise RuntimeError(f"the second library's pivot_fwd failed ({err})")

            other()
            row["equal_to_against"] = bool(torch.equal(y, y2))
            first = cuda_ms(other, reps)
            row["ms_runs"] = [cuda_ms(fwd, reps), cuda_ms(fwd, reps)]
            row["against_ms_runs"] = [first, cuda_ms(other, reps)]
        ms = row["ms"] = statistics.median(row["ms_runs"])
        row["plain_ms"] = plain_ms = cuda_ms(plain, reps)
        row["share_of_bound"], row["share_of_fp32_floor"] = b_ms / ms, fp32_ms / ms
        line = (f"pivot_fwd {name}: {ms:.3f} ms {row['ms_runs']}, plain (2 cuDNN conv2d) "
                f"{plain_ms:.3f} ms; bound {b_ms:.3f} ms ({b_by}, {b_ms / ms:.1%}), fp32 FMA "
                f"floor {fp32_ms:.3f} ms ({fp32_ms / ms:.1%}); max|y - y_plain| {err:.3e}; "
                f"plan {row['plan']}")
        if against is not None:
            line += (f"; second library {row['against_ms_runs']} ms, equal "
                     f"{row['equal_to_against']}")
        print(line + f" [{card}]")
        if phases:
            row["phases"] = ph = fwd_phase_cycles(x, wa, wb, bias, relu, co, reps, y)
            print(f"pivot_fwd {name} phases (cycles a step and CTA, share): " + "; ".join(
                f"{n} {c:.0f} ({ph['share'][n]:.1%})"
                for n, c in ph["cycles_per_step_and_cta"].items())
                + f"; {ph['ms_with_clocks']:.3f} ms with clocks, same bits {ph['same_bits']}")
        rows.append(row)
        del x, y
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--phases", action="store_true", help="also the per-phase cycles")
    ap.add_argument("--fwd", action="store_true", help="time pivot_fwd, not pivot_dw")
    ap.add_argument("--against", help="a second pivot.cu or built library to time in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_pivot: needs a CUDA device", file=sys.stderr)
        return 1
    fp32_parity()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    against = load_against(args.against) if args.against else None
    if args.fwd:
        print(json.dumps({"card": card, "pivot_fwd": profile_fwd(args.reps, card, against,
                                                                 args.phases)}))
        return 0
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
        dw = lambda: cuda_pivot.pivot_dw(x, g, DIMS)  # noqa: E731
        with torch.cuda.device(dev):
            grid = lib.fss_pivot_dw_blocks(1, ci, co, *DIMS)
        row = {"block": f"{ci}->{co}", "grid": grid, "plan": dw_plan(ci, co),
               "bound_ms": fwd_bounds(ci, co, q, s)[0], "max_abs_diff_vs_plain": err,
               "scale": max(float(b.abs().max()) for b in want)}
        if against is None:
            row["ms_runs"] = [cuda_ms(dw, args.reps)]
        else:   # in turns: the second library, this one, this one, the second
            other, flat = against_dw(against, x, g)
            other()
            mine = torch.cat([got[0].reshape(-1), got[1].reshape(-1), got[2]])
            row["max_abs_diff_vs_against"] = float((mine - flat).abs().max())
            first = cuda_ms(other, args.reps)
            row["ms_runs"] = [cuda_ms(dw, args.reps), cuda_ms(dw, args.reps)]
            row["against_ms_runs"] = [first, cuda_ms(other, args.reps)]
        ms = row["ms"] = statistics.median(row["ms_runs"])
        row["plain_ms"] = plain_ms = cuda_ms(lambda: cuda_pivot.pivot_dw_reference(x, g, DIMS),
                                             args.reps)
        row["ratio"], row["share_of_bound"] = ms / plain_ms, row["bound_ms"] / ms
        line = (f"pivot_dw {ci}->{co}: {ms:.3f} ms {row['ms_runs']}, plain (cuDNN wgrad) "
                f"{plain_ms:.3f} ms, ratio {ms / plain_ms:.3f}; bound {row['bound_ms']:.3f} ms "
                f"({row['share_of_bound']:.1%}); grid {grid}, plan {row['plan']}; "
                f"max|dw - dw_plain| {err:.3e}")
        if against is not None:
            line += (f"; second library {row['against_ms_runs']} ms, max|dw - dw_second| "
                     f"{row['max_abs_diff_vs_against']:.3e}")
        print(line + f" [{card}]")
        if args.phases:
            row["phases"] = ph = phase_cycles(x, g, args.reps)
            print(f"pivot_dw {ci}->{co} phases (cycles a step and CTA): " + "; ".join(
                f"{n} {c:.0f}" for n, c in ph["cycles_per_step_and_cta"].items())
                + f"; consumers' wait {ph['consumers_wait_share']:.1%} of their step; "
                f"{ph['ms_with_clocks']:.3f} ms with clocks, same bits {ph['same_bits']}")
        rows.append(row)
        del x, g
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "pivot_dw": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
