"""Alias trainer: the reference's DDP entry point (src/train_ddp.py) over the
generic head trainer, on one card, as the JAX alias runs on one device:

    python -m few_shot_seg_cwt_tpu_torch.train.train_ddp --config configs/pascal_ddp.yaml

The config's ``gpus`` list is read by no one, as in JAX. Training over
several processes waits for the port's scale-out (ROADMAP queue 1 item
13): a launch with ``WORLD_SIZE`` > 1, ``distributed`` or ``multi_host``
raises.
"""

import os

from ..config import parse_args
from .train_head import main as head_main


def main(cfg, device="cuda", log=print):
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world > 1 or cfg.get("distributed") or cfg.get("multi_host"):
        raise NotImplementedError(f"WORLD_SIZE={world}, distributed "
                                  f"{cfg.get('distributed')}, multi_host "
                                  f"{cfg.get('multi_host')}: training over several "
                                  "processes is not ported (ROADMAP queue 1 item 13)")
    return head_main(cfg, head_type="mmn", device=device, log=log)


if __name__ == "__main__":
    main(parse_args("ddp trainer (PyTorch/CUDA, one card)"))
