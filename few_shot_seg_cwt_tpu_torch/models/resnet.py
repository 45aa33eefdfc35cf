"""Dilated deep-stem ResNet backbone (PyTorch).

Counterpart of ``few_shot_seg_cwt_tpu.models.resnet``: ResNet-50/101 with

* the PSPNet "deep base" stem: three 3x3 convs 3->64->64->128 (BN, ReLU)
  and a 3x3 stride-2 max-pool, held as ``layer0`` with the reference's
  Sequential indices (conv ``0, 3, 6``, BN ``1, 4, 7``);
* layer3 with dilation 2 and layer4 with dilation 4, both stride 1, so the
  output stride is 8 (60x60 features at 473 px);
* BatchNorm with eps 1e-5, run on its running statistics (eval mode).

Parameter names are the reference repo's (``layerN.i.convK`` / ``bnK`` /
``downsample.{0,1}``), so a reference state_dict loads with
``load_state_dict``. Tensors are NCHW inside the module.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

# block counts per stage (reference: src/model/resnet.py:198,210)
RESNET_DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1,
         dilation: int = 1) -> nn.Conv2d:
    """Bias-free conv with torch-style 'same' padding for odd kernels."""
    return nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                     padding=dilation * (kernel - 1) // 2, dilation=dilation,
                     bias=False)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride/dilation) -> 1x1 (x4), with projection shortcut."""

    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False):
        super().__init__()
        self.conv1 = conv(in_ch, planes, 1)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = conv(planes, planes, 3, stride, dilation)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = conv(planes, planes * 4, 1)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample: Optional[nn.Sequential] = None
        if has_downsample:
            self.downsample = nn.Sequential(
                conv(in_ch, planes * 4, 1, stride), nn.BatchNorm2d(planes * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(out + residual)


class DilatedResNet(nn.Module):
    """Deep-stem dilated ResNet trunk: (N, 3, H, W) -> (N, 2048, H/8, W/8)."""

    def __init__(self, depth: int = 50):
        super().__init__()
        self.layer0 = nn.Sequential(
            conv(3, 64, 3, 2), nn.BatchNorm2d(64), nn.ReLU(inplace=True),
            conv(64, 64, 3), nn.BatchNorm2d(64), nn.ReLU(inplace=True),
            conv(64, 128, 3), nn.BatchNorm2d(128), nn.ReLU(inplace=True),
            nn.MaxPool2d(kernel_size=3, stride=2, padding=1),
        )
        # (planes, first-block stride, dilation) per stage; layers 3/4 dilated
        stage_spec = [(64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4)]
        in_ch = 128
        for idx, ((planes, stride, dilation), n_blocks) in enumerate(
                zip(stage_spec, RESNET_DEPTHS[depth]), start=1):
            blocks = []
            for b in range(n_blocks):
                blocks.append(Bottleneck(in_ch, planes, stride if b == 0 else 1,
                                         dilation, has_downsample=(b == 0)))
                in_ch = planes * 4
            setattr(self, f"layer{idx}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor, return_feats: bool = False):
        return run_trunk(self, x, return_feats)


def run_trunk(trunk: nn.Module, x: torch.Tensor, return_feats: bool = False):
    """``trunk.layer0..layer4`` (a DilatedResNet, or a PSPNet that holds the
    stages itself): (N, 3, H, W) -> (N, 2048, H/8, W/8); with
    ``return_feats`` also ``feats[stage] = [block outputs]`` for stages 1..4
    (NCHW), as the JAX trunk returns them."""
    x = trunk.layer0(x)
    feats = {}
    for stage in range(1, 5):
        outs = []
        for block in getattr(trunk, f"layer{stage}"):
            x = block(x)
            if return_feats:  # held only where a head reads them
                outs.append(x)
        feats[stage] = outs
    return (x, feats) if return_feats else x


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded torch-default init: kaiming-normal (fan_out) for conv kernels,
    unit/zero BN affine and zero/unit running stats."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                    nonlinearity="relu", generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            m.reset_running_stats()
