"""Alias trainer: the attention-variant head (reference: src/train_att.py), chosen by
``trans_type`` (``cross_att``, ``mha`` or ``att_blk``), over the generic head
trainer, on the GPU. No att config ships: it runs on configs/pascal_asy.yaml::

    python -m few_shot_seg_cwt_tpu_torch.train.train_att \
        --config configs/pascal_asy.yaml --opts trans_type cross_att data_root <VOC2012 tree>
"""

from ..config import parse_args
from ..parallel.mesh import shutdown
from .train_head import main as head_main


def main(cfg, device="cuda", log=print):
    return head_main(cfg, head_type="att", device=device, log=log)


if __name__ == "__main__":
    main(parse_args("att trainer (PyTorch/CUDA)"))
    shutdown()
