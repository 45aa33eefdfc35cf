"""Post-hoc log summarizer (reference: print_log.py:1-44); the port's copy of
``few_shot_seg_cwt_tpu.utils.print_log``.

Scrapes 'mIoU---Val result: mIoU <x>.' lines (the grammar our validators
print) from one or more log files and reports per-file bests + the mean.

CLI: python -m few_shot_seg_cwt_tpu_torch.utils.print_log <log.txt> [more.txt ...]
"""

from __future__ import annotations

import re
import sys
from typing import Dict, List

_PAT = re.compile(r"mIoU---Val result: mIoU ([0-9.]+)")


def scrape(path: str) -> List[float]:
    vals: List[float] = []
    with open(path) as f:
        for line in f:
            m = _PAT.search(line)
            if m:
                vals.append(float(m.group(1).rstrip(".")))
    return vals


def summarize(paths: List[str]) -> Dict[str, float]:
    best: Dict[str, float] = {}
    for p in paths:
        vals = scrape(p)
        if vals:
            best[p] = max(vals)
            print(f"{p}: {len(vals)} evals, best mIoU {best[p]:.4f}, "
                  f"last {vals[-1]:.4f}")
        else:
            print(f"{p}: no eval lines found")
    if best:
        mean = sum(best.values()) / len(best)
        print(f"mean best mIoU over {len(best)} logs: {mean:.4f}")
    return best


if __name__ == "__main__":
    summarize(sys.argv[1:])
