"""Shared trainer plumbing: seeds, debug limits, episode loaders, backbone.

Counterpart of ``few_shot_seg_cwt_tpu.train.common`` on one process.
Episodes are synthetic only: the real-data loader and transforms are not
ported yet (ROADMAP queue 1 item 4), and asking for them raises.
"""

from __future__ import annotations

import random
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.synthetic import SequentialBatches, ShuffledBatches, SyntheticEpisodicDataset
from ..models.pspnet import PSPNet, build_pspnet


def set_seeds(cfg) -> None:
    """Seed Python, numpy and torch's global generator (dropout draws)."""
    if cfg.manual_seed is not None:
        random.seed(cfg.manual_seed)
        np.random.seed(cfg.manual_seed)
        torch.manual_seed(cfg.manual_seed)


def apply_debug(cfg) -> None:
    """Shrink runs in debug mode (reference: src/train.py:295-299)."""
    if cfg.debug:
        cfg.test_num = min(cfg.test_num, 500)
        cfg.epochs = min(cfg.epochs, 2)
        cfg.n_runs = min(cfg.n_runs, 2)
        cfg.save_models = False


def episodic_loaders(cfg) -> Tuple[ShuffledBatches, SequentialBatches]:
    """Train (shuffled per epoch) and validation (in order, endless)
    batches of ``episode_batch`` synthetic episodes."""
    if not cfg.get("synthetic_data"):
        raise NotImplementedError(
            "the PyTorch port trains on synthetic episodes only: real datasets "
            "wait for the data loader and transforms (ROADMAP queue 1 item 4)")
    e = int(cfg.episode_batch)
    train = SyntheticEpisodicDataset(cfg, length=max(cfg.iter_per_epoch, 64), seed=1)
    val = SyntheticEpisodicDataset(cfg, length=max(cfg.test_num, 64), seed=2)
    return (ShuffledBatches(train, e, seed=cfg.manual_seed or 0),
            SequentialBatches(val, e))


def init_backbone(cfg, generator: Optional[torch.Generator] = None) -> PSPNet:
    """The frozen backbone: a seeded random PSPNet (``manual_seed``). Loading
    the stage-1 ``.pth`` by the reference's directory schema waits for the
    real-data path (ROADMAP queue 1 item 5)."""
    return build_pspnet(cfg, generator)
