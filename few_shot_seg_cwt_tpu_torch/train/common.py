"""Shared trainer plumbing: fp32 parity, seeds, debug limits, episode
loaders, backbone (with the stage-1 weights) and transformer inits,
checkpoint directory and auto-resume, and the per-rank parts of a train
state.

Counterpart of ``few_shot_seg_cwt_tpu.train.common``. Episodes come from a
dataset tree (``data_root`` + list files), a recorded episode log
(``replay``) or the synthetic generator (``synthetic_data``), through
``data.loader.EpisodeLoader`` onto the engine's device. Under a process
group (``parallel.mesh``; the JAX ``maybe_mesh``) each rank loads
``local_batch`` episodes of every global batch: validation by a
rank-strided index stream, training from its own shuffle seeded
``manual_seed + rank``.
"""

from __future__ import annotations

import os
import random
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.episodic import EpisodicDataset
from ..data.loader import EpisodeLoader
from ..data.replay import ReplayEpisodicDataset
from ..data.synthetic import SyntheticEpisodicDataset
from ..models.cwt import MultiHeadAttentionOne, build_cwt
from ..models.pspnet import PSPNet, build_pspnet
from ..parallel.mesh import gather_rows, rank_world
from ..utils.convert import load_torch_checkpoint
from ..utils.dirs import get_model_dir_trans


def fp32_parity() -> None:
    """Run float32 convolutions and matmuls in full float32 on the card: the
    reference is fp32, and PyTorch's default lets cuDNN use TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def set_seeds(cfg) -> None:
    """Seed Python, numpy and torch's global generator (dropout draws); the
    global generator with ``manual_seed + rank`` under a process group, so
    that the ranks' head dropout masks differ (the reference's per-rank
    seeds, src/train_ddp.py:59-66)."""
    if cfg.manual_seed is not None:
        random.seed(cfg.manual_seed)
        np.random.seed(cfg.manual_seed)
        torch.manual_seed(cfg.manual_seed + rank_world()[0])


def apply_debug(cfg) -> None:
    """Shrink runs in debug mode (reference: src/train.py:295-299)."""
    if cfg.debug:
        cfg.test_num = min(cfg.test_num, 500)
        cfg.epochs = min(cfg.epochs, 2)
        cfg.n_runs = min(cfg.n_runs, 2)
        cfg.save_models = False


def episodic_dataset(cfg, train: bool):
    """Validation episodes from a recorded log (``replay``), synthetic
    episodes (``synthetic_data``), or the sampler over a dataset tree."""
    if not train and cfg.get("replay"):
        return ReplayEpisodicDataset(cfg, str(cfg.replay))
    if cfg.get("synthetic_data"):
        n = cfg.iter_per_epoch if train else cfg.test_num
        return SyntheticEpisodicDataset(cfg, length=max(n, 64), seed=(1 if train else 2))
    return EpisodicDataset(cfg, train=train)


def local_batch(e: int, world: Optional[int] = None) -> int:
    """A rank's share of a global batch of ``e`` over ``world`` processes
    (the process group's by default; all of it without one), which must
    divide it, as the JAX ``_local_batch`` requires."""
    world = rank_world()[1] if world is None else world
    if e % world:
        raise ValueError(f"global batch {e} must divide over {world} processes")
    return e // world


def episodic_val_loader(cfg, device="cuda", rank: Optional[int] = None,
                        world: Optional[int] = None) -> EpisodeLoader:
    """Validation batches of ``local_batch(episode_batch)`` episodes in index
    order (wrap around with ``data.loader.infinite``); with several
    processes rank r takes indices r, r + world, ... (the
    DistributedSampler's stream, padded by wrap-around). ``rank`` and
    ``world`` default to the process group's. A replayed log is evaluated
    on one process only: the rank-padded index stream would score some
    recorded episodes twice."""
    group_rank, group_world = rank_world()
    rank = group_rank if rank is None else rank
    world = group_world if world is None else world
    if cfg.get("replay") and world > 1:
        raise ValueError(
            "replay evaluation is single-process only: the rank-padded index "
            f"stream would duplicate recorded episodes (world={world})")
    return EpisodeLoader(episodic_dataset(cfg, train=False),
                         batch_size=local_batch(int(cfg.episode_batch), world), shuffle=False,
                         num_workers=cfg.workers, device=device, rank=rank, world=world)


def episodic_loaders(cfg, device="cuda") -> Tuple[EpisodeLoader, EpisodeLoader]:
    """Train (shuffled per epoch by ``manual_seed + rank + epoch``) and
    validation loaders of ``local_batch(episode_batch)`` episodes: the JAX
    package's, whose train side gives each process its own seed
    (``manual_seed + process_index``)."""
    seed = (cfg.manual_seed or 0) + rank_world()[0]
    train = EpisodeLoader(episodic_dataset(cfg, train=True),
                          batch_size=local_batch(int(cfg.episode_batch)), shuffle=True,
                          num_workers=cfg.workers, seed=seed, device=device)
    return train, episodic_val_loader(cfg, device)


def stage1_weights_path(cfg) -> str:
    """The stage-1 PSPNet checkpoint under the reference's directory schema:
    <resume_weights>/<train_name>/split=<s>/pspnet_<arch><layers>/best.pth,
    or best1.pth with ``wt_file 1`` (src/train.py:57-59, src/train_aug.py:60)."""
    leaf = "best1.pth" if cfg.get("wt_file", 0) == 1 else "best.pth"
    return os.path.join(str(cfg.resume_weights), cfg.train_name, f"split={cfg.train_split}",
                        f"pspnet_{cfg.arch}{cfg.layers}", leaf)


def load_backbone_weights(backbone: PSPNet, path: str, skip_gamma: bool) -> None:
    """Overlay a reference PSPNet ``.pth`` onto ``backbone``, without the
    stage-1 classifier (and without ``gamma`` when ``skip_gamma``), as the
    reference's stage-2 filter does (src/train.py:65-71). Every other
    backbone tensor must be in the file."""
    skip = ("classifier.",) + (("gamma",) if skip_gamma else ())
    sd = {k: v for k, v in load_torch_checkpoint(path).items() if not k.startswith(skip)}
    missing, unexpected = backbone.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.startswith(skip)]
    if missing or unexpected:
        raise ValueError(f"{path}: missing {missing[:5]}, unexpected {unexpected[:5]}")


def load_stage1_weights(cfg, backbone: PSPNet, log=print) -> None:
    """Overlay the stage-1 weights at ``stage1_weights_path`` if the file
    exists (``classifier.*`` and ``gamma`` dropped), with the reference's
    log lines."""
    path = stage1_weights_path(cfg)
    if os.path.isfile(path):
        log(f"=> loading weight '{path}'")
        load_backbone_weights(backbone, path, skip_gamma=True)
        log(f"=> loaded weight '{path}'")
    else:
        log(f"=> no weight found at '{path}'")


def init_backbone(cfg, generator: Optional[torch.Generator] = None, log=print) -> PSPNet:
    """The frozen backbone: a seeded random PSPNet (``manual_seed``), with
    the stage-1 weights overlaid when ``resume_weights`` is set."""
    backbone = build_pspnet(cfg, generator)
    if cfg.get("resume_weights"):
        load_stage1_weights(cfg, backbone, log)
    return backbone


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


def with_rank_states(state: dict, rng_state: torch.Tensor) -> dict:
    """A train state (``utils.ckpt.pack_train_state``) with the world size in
    its ``meta`` and, under a process group, every rank's generator state
    (``rng_ranks``, (world, n), gathered in rank order: every rank must
    call this, though rank 0 alone writes the file)."""
    world = rank_world()[1]
    state["meta"]["world"] = world
    if world > 1:
        state["rng_ranks"] = gather_rows(rng_state.to(torch.int32)[None]).to(rng_state.dtype)
    return state


def rank_rng_state(state: dict) -> torch.Tensor:
    """This rank's generator state from a train state of ``with_rank_states``;
    a state written at another world size raises, naming both."""
    rank, world = rank_world()
    saved = int(state["meta"].get("world", 1))
    if saved != world:
        raise ValueError(f"the train state was written by {saved} process(es) and this run "
                         f"has {world}: an exact resume needs the same world size")
    # a row of its own: set_state reads the tensor's storage from its start
    return state["rng_ranks"][rank].clone() if world > 1 else state["rng"]

