"""The port's checkpoints: ``torch.save`` files of state_dicts.

Counterparts of ``save_ckpt``, ``load_ckpt``, ``pack_train_state`` and
``is_full_train_state`` in ``few_shot_seg_cwt_tpu.utils.ckpt``. A model
checkpoint (``best.pth``, ``final.pth``) is a module's ``state_dict``, the
reference's format, so ``utils.convert.load_torch_checkpoint`` and
``load_state_dict`` read it. A full train state (``train_state.pth``) is
``{"model", "optimizer", "rng", "meta"}`` (plus ``"scheduler"`` where the
trainer steps one): the reference saves ``{'epoch', 'state_dict',
'optimizer'}`` (src/train.py:141-163), and the generator state lets a
resumed run continue the exact step stream. The JAX package's orbax
checkpoints are not read here: that needs JAX.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch


def save_ckpt(path: str, obj: Any) -> None:
    """``torch.save`` through a temporary file and a rename, so that a run
    stopped mid-write leaves the previous checkpoint whole."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def load_ckpt(path: str) -> Any:
    """A checkpoint's contents on the host; tensors and plain containers only
    (``weights_only``: a checkpoint is data)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def pack_train_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                     generator_state: Optional[torch.Tensor], epoch: int, best: float,
                     scheduler=None, **extra_meta: float) -> Dict[str, Any]:
    """Everything a run needs to continue after ``epoch``: the model's and
    optimizer's state_dicts, the step generator's state, and the epoch and
    best validation score (``extra_meta`` adds other scores)."""
    meta = {"epoch": int(epoch), "best": float(best)}
    meta.update({k: float(v) for k, v in extra_meta.items()})
    state = {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
             "rng": generator_state, "meta": meta}
    if scheduler is not None:
        state["scheduler"] = scheduler.state_dict()
    return state


def is_full_train_state(path: str) -> bool:
    """Does this checkpoint carry the optimizer's state (not weights alone)?"""
    raw = load_ckpt(path)
    return isinstance(raw, dict) and "optimizer" in raw and "meta" in raw
