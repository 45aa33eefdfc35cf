"""Alias trainer: MMN with meta-augmented support streams (reference:
src/train_aug.py) over the generic head trainer, on the GPU; enable with
``--opts meta_aug 2 aug_type 0`` (``att_type`` 0, 1 or 3 picks the support
view the head reads, ``HeadEngine._select_support_stream``):

    python -m few_shot_seg_cwt_tpu_torch.train.train_aug --config configs/pascal_aug.yaml
"""

from ..config import parse_args
from .train_head import main as head_main


def main(cfg, device="cuda", log=print):
    return head_main(cfg, head_type="mmn", device=device, log=log)


if __name__ == "__main__":
    main(parse_args("aug trainer (PyTorch/CUDA)"))
