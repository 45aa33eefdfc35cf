"""Shared trainer plumbing: seeds, debug limits, episode loaders, backbone
and transformer inits, checkpoint directory and auto-resume.

Counterpart of ``few_shot_seg_cwt_tpu.train.common`` on one process.
Episodes are synthetic only: the real-data loader and transforms are not
ported yet (ROADMAP queue 1 item 4), and asking for them raises.
"""

from __future__ import annotations

import os
import random
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.synthetic import SequentialBatches, ShuffledBatches, SyntheticEpisodicDataset
from ..models.cwt import MultiHeadAttentionOne, build_cwt
from ..models.pspnet import PSPNet, build_pspnet
from ..utils.dirs import get_model_dir_trans


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


def init_cwt(cfg, generator: Optional[torch.Generator] = None) -> MultiHeadAttentionOne:
    """The transformer to meta-train: a seeded random init (``manual_seed``
    + 1, as the JAX package seeds it)."""
    return build_cwt(cfg, generator)


def trans_ckpt_dir(cfg) -> str:
    """Where the CWT trainer writes and ``train.test`` reads transformer
    checkpoints (the reference's schema)."""
    return get_model_dir_trans(cfg)


def maybe_auto_resume(cfg, state_path: str, log=print) -> None:
    """``auto_resume``: pick up this run's own train state at ``state_path``
    when one exists, so that a preempted job restarted with the same command
    continues where it stopped."""
    if cfg.get("auto_resume") and not cfg.get("resume_ckpt") and os.path.exists(state_path):
        cfg.resume_ckpt = os.path.abspath(state_path)
        log(f"=> auto_resume: found {cfg.resume_ckpt}")
