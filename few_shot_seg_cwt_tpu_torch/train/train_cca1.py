"""Adaptive incremental CCA trainer, on the GPU (reference: src/train_cca1.py):

    python -m few_shot_seg_cwt_tpu_torch.train.train_cca1 \
        --config configs/pascal_cca.yaml --opts data_root <VOC2012 tree>

``train_cca`` with the episode-adaptive class growth: the support labels
are relabelled from the base classifier's pseudo labels
(``adapt_reset_spt_label``) in a host pass before each step. One process.
"""

from ..config import parse_args
from .train_cca import main as cca_main


def main(cfg, device="cuda", log=print):
    return cca_main(cfg, adaptive=True, device=device, log=log)


if __name__ == "__main__":
    main(parse_args("adaptive incremental CCA trainer (PyTorch/CUDA)"))
