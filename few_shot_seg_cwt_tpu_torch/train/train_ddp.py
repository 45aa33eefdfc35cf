"""Alias trainer: the reference's DDP entry point (src/train_ddp.py) over the
generic head trainer, which trains the MMN head over as many processes as
``torchrun`` starts, one a card (``parallel.mesh``):

    torchrun --nproc_per_node N -m few_shot_seg_cwt_tpu_torch.train.train_ddp \
        --config configs/pascal_ddp.yaml

Without ``torchrun`` it trains on one card. The config's ``gpus`` list is
read by no one, as in JAX: the cards are the processes ``torchrun`` starts.
"""

from ..config import parse_args
from ..parallel.mesh import shutdown
from .train_head import main as head_main


def main(cfg, device="cuda", log=print):
    return head_main(cfg, head_type="mmn", device=device, log=log)


if __name__ == "__main__":
    main(parse_args("ddp trainer (PyTorch/CUDA)"))
    shutdown()
