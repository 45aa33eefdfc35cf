"""Where the inner-loop kernel's time goes on the card (K1, or K2 with --tile).

    python -m few_shot_seg_cwt_tpu_torch.tools.profile_inner_loop [--episodes 8] [--steps 200] [--tile 1]

Builds ``csrc/inner_loop.cu`` twice: as the main path runs it, and with
``-DFSS_PHASE_CLOCKS``, where thread 0 of each CTA adds the cycles of each
phase (up to the block-wide barrier that closes it) to one device counter
per phase; the waits at the three group barriers a step are phases of
their own. On the main path's shapes (1-shot, 60x60x512 features, 473x473
pixel weights) it prints:

* the work plan (grid, CTAs per group of ``tile`` episodes, rows per slice,
  pixels of f pinned in shared memory per chain);
* the kernel's time by CUDA events in both builds (the instrumentation's
  cost) and the effective SM clock (cycles per CTA over milliseconds);
* per phase: cycles per step and CTA, share, and per SM cycle (one CTA an
  SM) the FMAs of the function done there (an SM issues at most 128 fp32
  FMAs a cycle) and the bytes of f and pws it reads (L1, L2 or HBM; the
  pinned share of f from shared memory);
* the kernel's device time as ``torch.profiler`` (CUPTI) records it, or
  that the trace held none.

The last line is one JSON object with all of it. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from typing import Dict, List

import numpy as np
import torch

from ..data.synthetic import make_episode_batch
from ..episodic.inner_loop import binary_pixel_weights
from ..ops import cuda_inner_loop
from ..ops.inner_loop_plan import tap_table

PHASE_DEFINES = ("-DFSS_PHASE_CLOCKS",)
PHASES = ("d = f.u", "barrier 1 (d halo)", "T = d B^T", "D, g, A^T g", "A^T g halo out",
          "barrier 2 (A^T g halo)", "G = (A^T g) B", "acc partials = G.f",
          "barrier 3 (partials)", "acc reduce, u")


def phase_work(h: int, w: int, c: int, big_h: int, big_w: int) -> List[Dict]:
    """Per phase, for one chain (episode shot) and one step of the function
    in its two-tap form: the FMAs and the global bytes the phase's loads of
    f and pws stand for. T and D take two taps an element (the second
    weight may be 0), A^T g and (A^T g) B one FMA per non-zero of A and B.
    The halo T rows a slice recomputes, the compensation of the acc sums
    and the reduction's adds are not counted."""
    nnz_a = int(np.count_nonzero(tap_table(big_h, h).dense()))
    nnz_b = int(np.count_nonzero(tap_table(big_w, w).dense()))
    hwc = h * w * c
    zero = {"fma": 0, "bytes": 0}
    return [
        {"fma": hwc, "bytes": 4 * hwc}, zero,
        {"fma": 2 * h * big_w, "bytes": 0},
        {"fma": 2 * big_h * big_w + nnz_a * big_w, "bytes": 4 * big_h * big_w},
        zero, zero,
        {"fma": h * nnz_b, "bytes": 0},
        {"fma": hwc, "bytes": 4 * hwc}, zero, zero,
    ]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn()`` by CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiler_device_ms(fn, kernel: str = "adapt_binary_kernel") -> Dict:
    """The device time of ``kernel`` as torch.profiler records it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if kernel in ev.key:
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = getattr(ev, "cuda_time_total", 0.0)
            return {"found": True, "name": ev.key, "device_ms": us / 1e3,
                    "count": ev.count}
    return {"found": False}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--episodes", type=int, default=8)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tile", type=int, default=1, help="episodes per CTA (K2 above 1)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_inner_loop: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    e, h, c, big, steps, lr = args.episodes, 60, 512, 473, args.steps, 0.1

    rng = np.random.default_rng(2021)
    dev = torch.device("cuda")
    f_s = torch.tensor(np.abs(rng.standard_normal((e, 1, h, h, c))).astype(np.float32),
                       device=dev)
    labels = make_episode_batch(7, e, size=big, shot=1)["s_label"]
    pw, pwy = binary_pixel_weights(torch.tensor(labels, device=dev).long())
    u0 = torch.tensor((rng.uniform(-2, 2, (e, c)) / np.sqrt(c)).astype(np.float32),
                      device=dev)

    plain_lib = cuda_inner_loop.load_library()
    clock_lib = cuda_inner_loop.load_library(PHASE_DEFINES)
    clock_lib.fss_phase_cycles.argtypes = [np.ctypeslib.ndpointer(np.uint64)]
    clock_lib.fss_phase_cycles.restype = ctypes.c_int

    tile = args.tile
    plan = cuda_inner_loop.card_plan(plain_lib, tuple(f_s.shape), big, big, tile, dev)

    def run(lib):
        return cuda_inner_loop.launch(lib, f_s, pw, pwy, u0, steps, lr, tile, plan)

    acc_plain = run(plain_lib)
    acc_clock = run(clock_lib)
    torch.cuda.synchronize()
    same = bool(torch.equal(acc_plain, acc_clock))
    ms = cuda_ms(lambda: run(plain_lib), args.reps)
    ms_clock = cuda_ms(lambda: run(clock_lib), args.reps)

    cycles = np.zeros(len(PHASES), dtype=np.uint64)
    if clock_lib.fss_phase_cycles(cycles) != 0:  # read and zero
        raise RuntimeError("fss_phase_cycles failed")
    run(clock_lib)
    torch.cuda.synchronize()
    if clock_lib.fss_phase_cycles(cycles) != 0:
        raise RuntimeError("fss_phase_cycles failed")
    all_ctas = cycles.astype(np.float64)
    per_cta = all_ctas / plan.grid   # a CTA's phases over all its waves
    total = float(per_cta.sum())
    clock_ghz = total / (ms_clock * 1e-3) / 1e9
    phases = []
    for name, cyc, cyc_all, work in zip(PHASES, per_cta, all_ctas,
                                        phase_work(h, h, c, big, big)):
        phases.append({
            "phase": name, "cycles_per_step": float(cyc) / steps,
            "share": float(cyc) / total, "ms": ms_clock * float(cyc) / total,
            "fma_per_cycle": e * steps * work["fma"] / max(float(cyc_all), 1.0),
            "bytes_per_cycle": e * steps * work["bytes"] / max(float(cyc_all), 1.0),
        })
    prof = profiler_device_ms(lambda: run(plain_lib), "adapt_binary_kernel" if tile == 1
                              else "adapt_binary_tiled_kernel")

    print(f"card: {card}")
    print(f"{'K1' if tile == 1 else f'K2 (tile {tile})'}, E={e}, 1-shot, {h}x{h}x{c} -> "
          f"{big}x{big}, {steps} steps, plan {plan.summary()}: "
          f"{ms:.3f} ms; with phase clocks {ms_clock:.3f} ms (same acc: {same}); "
          f"{total:.4g} cycles per CTA, effective clock {clock_ghz:.3f} GHz")
    for p in phases:
        print(f"  {p['phase']:<22} {p['share']:6.1%} {p['ms']:8.3f} ms  "
              f"{p['cycles_per_step']:9.0f} cyc/step  {p['fma_per_cycle']:6.2f} FMA/cyc  "
              f"{p['bytes_per_cycle']:7.2f} B/cyc")
    print(f"torch.profiler: {prof}")
    print(json.dumps({"card": card, "episodes": e, "tile": tile, "steps": steps, "ms": ms,
                      "ms_with_clocks": ms_clock, "same_acc": same, "plan": plan.summary(),
                      "cycles_per_cta": total, "clock_ghz": clock_ghz,
                      "phases": phases, "profiler": prof}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
