"""Alias trainer: the correspondence-matching heads (reference:
src/train_match.py) over the generic head trainer, on the GPU:

    python -m few_shot_seg_cwt_tpu_torch.train.train_match \
        --config configs/pascal_match.yaml --opts data_root <VOC2012 tree>

``crm_type nc`` trains the MatchNet neighbourhood-consensus head
(``head "match"``), ``crm_type chm`` the convolutional Hough matcher
(``head "chm"``).
"""

from ..config import parse_args
from ..parallel.mesh import shutdown
from .train_head import main as head_main


def main(cfg, device="cuda", log=print):
    head = "chm" if cfg.get("crm_type", "nc") == "chm" else "match"
    return head_main(cfg, head_type=head, device=device, log=log)


if __name__ == "__main__":
    main(parse_args("match trainer (PyTorch/CUDA)"))
    shutdown()
