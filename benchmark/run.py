"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up makes the cell's weights and inputs on
the device from ``--seed``, builds the program and warms it up; the window
runs the cell's traffic for ``--seconds``; with ``--trace 1`` a traced
window of the traffic's ``trace_items`` follows, and the line carries the
per-layer metrics instead of the end-to-end ones. Then the program is
dropped and the reference checks a seeded sample of what the window
produced. The last line of standard output is the result (JSON); the
checks, each reading beside its limit, are the last lines of standard
error. Exits 2 without a card (or with fewer than the cell asks for), and
1 when a module of the JAX stack or the JAX package is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT))
    from benchmark.harness.spec import load_cell

    cell = load_cell(args.workload)
    # the route is read by the program when it is imported and when it runs
    os.environ.update(cell.config.get("env", {}))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2

    from benchmark.harness import contract, runner

    result, found = runner.run(cell, args.seed, args.seconds, bool(args.trace), T_START)
    if found:
        print(f"modules of the JAX stack or package loaded: {found}", file=sys.stderr)
        return 1
    contract.print_checks(result["checks"])
    print(contract.result_line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
