"""Alias trainer: reference kshot entry point -> generic head trainer.

MMN k-shot meta-training (reference: src/train_kshot.py). AMP maps to the
compute_dtype config; per-shot loss aggregation via loss_shot avg|sum.
CLI parity: `python -m few_shot_seg_cwt_tpu_torch.train.train_kshot --config ... --opts ...`.
"""

from ..config import parse_args
from ..parallel.mesh import shutdown
from .train_head import main as head_main


def main(cfg, device="cuda", log=print):
    return head_main(cfg, head_type="mmn", device=device, log=log)


if __name__ == "__main__":
    main(parse_args("kshot trainer (PyTorch/CUDA)"))
    shutdown()
