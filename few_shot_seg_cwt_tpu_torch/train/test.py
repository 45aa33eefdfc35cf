"""Evaluation entry point (mIoU over n_runs x test_num episodes), on the GPU.

Counterpart of ``few_shot_seg_cwt_tpu.train.test``:

    python -m few_shot_seg_cwt_tpu_torch.train.test --config configs/pascal.yaml \
        --opts synthetic_data True test_num 16 n_runs 1

Backbone weights load from ``resume_weights`` when it names a reference
``.pth`` file; transformer weights from ``<ckpt_used>.pth`` under the
reference's transformer directory schema. Without them the run evaluates the
seeded random init (plumbing mode). Only synthetic episodes are supported so
far; real datasets need the data loader and transforms, not yet ported.
"""

from __future__ import annotations

import os
import random

import numpy as np

from ..config import parse_args
from ..data.synthetic import SequentialBatches, SyntheticEpisodicDataset
from ..episodic.engine import EpisodicEngine
from ..eval.validate import validate_transformer
from ..utils.convert import load_torch_checkpoint


def transformer_ckpt_dir(cfg) -> str:
    """Reference schema (src/util.py:152-179)."""
    return os.path.join(cfg.model_dir, cfg.train_name, f"split={cfg.train_split}",
                        "model", f"shot_{cfg.shot}",
                        f"transformer_{cfg.arch}{cfg.layers}")


def load_eval_weights(cfg, engine: EpisodicEngine, log=print) -> None:
    """Overlay reference ``.pth`` weights onto the engine's modules, if any."""
    path = str(cfg.resume_weights or "")
    if os.path.isfile(path):
        sd = {k: v for k, v in load_torch_checkpoint(path).items()
              if not k.startswith("classifier.")}  # stage-2 filter
        missing, unexpected = engine.backbone.load_state_dict(sd, strict=False)
        missing = [k for k in missing if not k.startswith("classifier.")]
        if missing or unexpected:
            raise ValueError(f"{path}: missing {missing[:5]}, unexpected {unexpected[:5]}")
        log(f"=> loaded weight '{path}'")
    if cfg.ckpt_used is None:
        log("=> Not loading anything")
        return
    trans = os.path.join(transformer_ckpt_dir(cfg), f"{cfg.ckpt_used}.pth")
    if os.path.isfile(trans):
        engine.cwt.load_state_dict(load_torch_checkpoint(trans))
        log(f"=> loading transformer weight '{trans}'")
    else:
        log(f"=> no transformer ckpt at '{trans}', evaluating random init")


def main(cfg, device="cuda", log=print) -> float:
    if not cfg.get("synthetic_data"):
        raise NotImplementedError(
            "the PyTorch port evaluates synthetic episodes only: real datasets "
            "wait for the data loader and transforms (ROADMAP, queue 1: "
            "'Data loader and transforms', then 'Real-data train/test.py')")
    if cfg.manual_seed is not None:
        random.seed(cfg.manual_seed)
        np.random.seed(cfg.manual_seed)
    if cfg.debug:
        cfg.test_num = min(cfg.test_num, 500)
        cfg.n_runs = min(cfg.n_runs, 2)

    engine = EpisodicEngine(cfg, device=device)
    load_eval_weights(cfg, engine, log)
    dataset = SyntheticEpisodicDataset(cfg, length=max(cfg.test_num, 64), seed=2)
    loader = SequentialBatches(dataset, int(cfg.episode_batch))
    miou, _ = validate_transformer(cfg, engine, loader, log=log)
    return miou


if __name__ == "__main__":
    main(parse_args("Testing (PyTorch/CUDA)"))
