"""Alias trainer: FuseNet1 fusion weights over a frozen MatchNet (reference:
src/train_fuse.py), over the generic head trainer, on the GPU; ``matchnet_ckpt``
names the ``train_match`` checkpoint to freeze::

    python -m few_shot_seg_cwt_tpu_torch.train.train_fuse \
        --config configs/pascal_fuse.yaml --opts matchnet_ckpt <best.pt> data_root <VOC2012 tree>
"""

from ..config import parse_args
from ..parallel.mesh import shutdown
from .train_head import main as head_main


def main(cfg, device="cuda", log=print):
    return head_main(cfg, head_type="fuse", device=device, log=log)


if __name__ == "__main__":
    main(parse_args("fuse trainer (PyTorch/CUDA)"))
    shutdown()
