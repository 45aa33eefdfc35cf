"""Dataset statistics: per-class foreground pixel ratios over episodes.

Counterpart of ``few_shot_seg_cwt_tpu.train.train_count`` (reference:
src/train_count.py:60-88): samples ``test_num`` training episodes and
averages, per class, the FG/ALL ratio of the support masks (255 left out)
— a check of a new ``data_root`` / list file. It builds no model and runs
on the host:

    python -m few_shot_seg_cwt_tpu_torch.train.train_count \
        --config configs/pascal.yaml [--opts test_num 2000]
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

import numpy as np

from ..config import parse_args
from .common import apply_debug, episodic_dataset, set_seeds


def main(cfg, log=print) -> Dict[int, float]:
    """{class: mean FG ratio of its episodes' supports}, printed as the JAX
    trainer prints it."""
    set_seeds(cfg)
    apply_debug(cfg)
    ds = episodic_dataset(cfg, train=True)
    n = cfg.test_num if cfg.get("synthetic_data") else min(cfg.test_num, len(ds))
    ratios = defaultdict(list)
    for i in range(n):
        ep = ds[i % len(ds)]
        lab = np.asarray(ep["s_label"])
        valid = lab != 255
        fg = int(((lab == 1) & valid).sum())
        total = int(valid.sum())
        if total:
            ratios[int(ep["cls"])].append(fg / total)
    log(f"class ratios over {n} episodes:")
    out = {}
    for c in sorted(ratios):
        out[c] = float(np.mean(ratios[c]))
        log(f"  class {c}: fg/all = {out[c]:.4f} (n={len(ratios[c])})")
    return out


if __name__ == "__main__":
    main(parse_args("episode statistics"))
