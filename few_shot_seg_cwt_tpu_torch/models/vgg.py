"""VGG-16 (batch-norm) backbone (PyTorch).

Counterpart of ``few_shot_seg_cwt_tpu.models.vgg.VGG16BN`` (``arch: vgg``).
The reference slices torchvision's ``vgg16_bn().features`` into five
Sequential stages (reference: src/model/pspnet.py:41-67), renumbered from 0
in each: stage 0 = 2x conv64 + pool, 1 = 2x conv128 + pool, 2 = 3x conv256
+ pool, 3 = 3x conv512 + pool, 4 = 3x conv512 (no trailing pool), each conv
followed by BN and ReLU, so convs sit at indices 0/3/6 and BNs at 1/4/7.
The dilation surgery does not touch VGG: the output stride is 16, and the
pools are ``ceil_mode`` (30x30 features at 473 px). The names are the
reference's (``layer0..layer4``), so a reference ``.pth`` loads with
``load_state_dict``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .resnet import BatchNorm2d, run_trunk

# (number of convs, channels, trailing max-pool) per stage
VGG16_STAGES = ((2, 64, True), (2, 128, True), (3, 256, True), (3, 512, True),
                (3, 512, False))


class VGG16BN(nn.Module):
    """Five-stage VGG-16bn trunk: (N, 3, H, W) -> (N, 512, ~H/16, ~W/16)."""

    arch = "vgg"

    def __init__(self):
        super().__init__()
        in_ch = 3
        for idx, (n_convs, ch, pool) in enumerate(VGG16_STAGES):
            mods = []
            for _ in range(n_convs):
                mods += [nn.Conv2d(in_ch, ch, 3, padding=1), BatchNorm2d(ch),
                         nn.ReLU(inplace=True)]
                in_ch = ch
            if pool:
                mods.append(nn.MaxPool2d(kernel_size=2, stride=2, ceil_mode=True))
            setattr(self, f"layer{idx}", nn.Sequential(*mods))

    def forward(self, x: torch.Tensor, return_feats: bool = False):
        return run_trunk(self, x, return_feats)
