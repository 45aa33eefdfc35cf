"""Checkpoint directory schema (reference: src/util.py:152-179).

The port's own copy of ``few_shot_seg_cwt_tpu.utils.dirs``.
"""

from __future__ import annotations

import os


def get_model_dir(cfg) -> str:
    return os.path.join(cfg.model_dir, cfg.train_name, f"split={cfg.train_split}",
                        "model", f"shot_{cfg.shot}", f"pspnet_{cfg.arch}{cfg.layers}")


def get_model_dir_trans(cfg) -> str:
    return os.path.join(cfg.model_dir, cfg.train_name, f"split={cfg.train_split}",
                        "model", f"shot_{cfg.shot}", f"transformer_{cfg.arch}{cfg.layers}")
