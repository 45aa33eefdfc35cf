"""Evaluation entry point (mIoU over n_runs x test_num episodes), on the GPU.

Counterpart of ``few_shot_seg_cwt_tpu.train.test``:

    python -m few_shot_seg_cwt_tpu_torch.train.test --config configs/pascal.yaml \
        --opts data_root <VOC2012 tree> test_num 1000 n_runs 5

Episodes come from the dataset tree (``data_root``, ``val_list``), from a
recorded episode log (``--opts replay <episodes.jsonl>``: one stream across
runs, so ``episode_batch`` must divide ``test_num``), or from the synthetic
generator (``--opts synthetic_data True``).

Backbone weights load from ``resume_weights`` when it names a reference
``.pth`` file (``classifier.*`` dropped), else by the stage-1 directory
schema (``train.common.load_stage1_weights``; ``classifier.*`` and ``gamma``
dropped); transformer weights from ``<ckpt_used>.pth`` under the
reference's transformer directory schema. Without them the run evaluates the
seeded random init (plumbing mode).

Over several cards, ``torchrun --nproc_per_node N -m
few_shot_seg_cwt_tpu_torch.train.test ...``: every rank reads the weights,
scores its rank-strided slice of each batch of ``episode_batch``, and the
ranks' episodes are gathered before scoring (``eval.validate``); rank 0
alone prints.
"""

from __future__ import annotations

import os

from ..config import parse_args
from ..episodic.engine import EpisodicEngine
from ..eval.validate import validate_transformer
from ..parallel.mesh import broadcast_module, distributed_init, is_main_process, shutdown
from ..utils.convert import load_torch_checkpoint
from .common import (apply_debug, episodic_val_loader, fp32_parity, load_backbone_weights,
                     load_stage1_weights, set_seeds, trans_ckpt_dir)


def load_eval_backbone(cfg, backbone, log=print) -> None:
    """Overlay reference ``.pth`` weights onto ``backbone``, if any: from a
    file named by ``resume_weights`` (``gamma`` kept), else by the stage-1
    schema (``gamma`` dropped), as the JAX package's ``load_backbone_weights``
    does."""
    path = str(cfg.resume_weights or "")
    if os.path.isfile(path):
        load_backbone_weights(backbone, path, skip_gamma=False)
        log(f"=> loaded weight '{path}'")
    elif path:
        load_stage1_weights(cfg, backbone, log)


def load_eval_weights(cfg, engine: EpisodicEngine, log=print) -> None:
    """Overlay reference ``.pth`` weights onto the engine's modules, if any:
    the backbone by ``load_eval_backbone``, the transformer from
    ``<ckpt_used>.pth``."""
    load_eval_backbone(cfg, engine.backbone, log)
    if cfg.ckpt_used is None:
        log("=> Not loading anything")
        return
    trans = os.path.join(trans_ckpt_dir(cfg), f"{cfg.ckpt_used}.pth")
    if os.path.isfile(trans):
        engine.cwt.load_state_dict(load_torch_checkpoint(trans))
        log(f"=> loading transformer weight '{trans}'")
    else:
        log(f"=> no transformer ckpt at '{trans}', evaluating random init")


def main(cfg, device="cuda", log=print) -> float:
    device = distributed_init(cfg, device=device)
    if not is_main_process():
        log = lambda *_: None  # noqa: E731 (rank 0 alone prints)
    fp32_parity()
    set_seeds(cfg)
    apply_debug(cfg)

    engine = EpisodicEngine(cfg, device=device)
    load_eval_weights(cfg, engine, log)
    broadcast_module(engine.backbone)
    broadcast_module(engine.cwt)
    loader = episodic_val_loader(cfg, device=engine.device)
    miou, _ = validate_transformer(cfg, engine, loader, log=log)
    return miou


if __name__ == "__main__":
    main(parse_args("Testing (PyTorch/CUDA)"))
    shutdown()
