"""The comparison's two readings for a cell, on the card: what the program
gives on each seed, and what the control gives, the reference at TF32 put
in the program's place on the same inputs (the nearest precision below
the configurations' fp32 with TF32 off). Not part of a benchmark run.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 3

One JSON line a seed: {"seed", "program": {reading: value}, "control": ...};
``--control 0`` reads the program alone; ``--fault <name>`` plants one of
the cell's faults (``faults/<cell>.py``) in the program first.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from benchmark.harness.spec import fault, load_cell

    cell = load_cell(args.workload)
    planted = fault(cell, args.fault) if args.fault else None
    os.environ.update(cell.config.get("env", {}))
    import random

    import torch

    from benchmark.harness import ddp, runner

    if not torch.cuda.is_available():
        print("control.py reads the card", file=sys.stderr)
        return 2
    if planted is not None:
        planted(setattr)
        os.environ[ddp.FAULT_ENV] = args.fault        # and in every other rank
    for seed in (int(s) for s in args.seeds.split(",")):
        drv, ctx, state = runner.prepare(cell, seed, "cuda")
        records, _ = runner.window(drv, state, args.seconds, ctx.device)
        drv.free(state)
        torch.cuda.empty_cache()
        out = {"seed": seed, "items": len(records),
               "program": drv.readings(state, records, ctx)}
        if args.control:
            drv.control(state, records)
            ctx.rng = random.Random(seed)
            out["control"] = drv.readings(state, records, ctx)
        print(json.dumps(out), flush=True)
        del state, records
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
