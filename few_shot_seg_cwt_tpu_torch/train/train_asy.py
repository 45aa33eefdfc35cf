"""Alias trainer: the transductive gamma blend (reference: src/train_asy.py),
one trainable scalar, over the generic head trainer, on the GPU::

    python -m few_shot_seg_cwt_tpu_torch.train.train_asy \
        --config configs/pascal_asy.yaml --opts data_root <VOC2012 tree>
"""

from ..config import parse_args
from ..parallel.mesh import shutdown
from .train_head import main as head_main


def main(cfg, device="cuda", log=print):
    return head_main(cfg, head_type="asy", device=device, log=log)


if __name__ == "__main__":
    main(parse_args("asy trainer (PyTorch/CUDA)"))
    shutdown()
