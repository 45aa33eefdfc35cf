"""PSPNet feature extractor and episodic classifier (PyTorch, fp32).

Counterpart of ``few_shot_seg_cwt_tpu.models.pspnet`` for the ResNet arch
with ``dist: dot``:

* Pyramid Pooling Module: adaptive-avg-pool to bins [1, 2, 3, 6] -> 1x1
  conv + BN + ReLU -> bilinear (align_corners) upsample -> concat;
* bottleneck: 3x3 conv 4096->512 + BN + ReLU + channel dropout;
* ``DotCls``: the plain 1x1-conv classifier;
* ``extract_features`` takes and returns NHWC, like the JAX package.

Module and parameter names are the reference repo's (``layer0..layer4``,
``ppm.features.i.{1,2}``, ``bottleneck.{0,1}``, ``classifier.weight``,
``gamma``), so ``utils.convert`` carries flax variables across by name and a
reference ``.pth`` loads with ``load_state_dict``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import DilatedResNet, reset_parameters


def init_classifier_weights(generator: torch.Generator, num_classes: int,
                            in_dim: int, device="cpu") -> torch.Tensor:
    """Fresh episodic (K, C) classifier weights, torch Conv2d default init
    U(+-1/sqrt(in_dim)), drawn from ``generator`` on the host so that a seed
    gives the same weights on every device."""
    bound = 1.0 / math.sqrt(in_dim)
    w = torch.rand((num_classes, in_dim), generator=generator,
                   dtype=torch.float32) * (2 * bound) - bound
    return w.to(device)


def apply_classifier(weights: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
    """1x1 conv as einsum.

    (K, C) weights x (..., h, w, C) features -> (..., h, w, K), or per-episode
    (E, K, C) weights x (E, h, w, C) features -> (E, h, w, K).
    """
    if weights.ndim == 2:
        return torch.einsum("...hwc,kc->...hwk", features, weights)
    return torch.einsum("ehwc,ekc->ehwk", features, weights)


class PPM(nn.Module):
    """Pyramid Pooling Module (NCHW)."""

    def __init__(self, in_dim: int, reduction_dim: int, bins: Sequence[int]):
        super().__init__()
        self.features = nn.ModuleList([
            nn.Sequential(
                nn.AdaptiveAvgPool2d(b),
                nn.Conv2d(in_dim, reduction_dim, kernel_size=1, bias=False),
                nn.BatchNorm2d(reduction_dim),
                nn.ReLU(inplace=True),
            )
            for b in bins
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = x.shape[-2:]
        outs = [x]
        for f in self.features:
            outs.append(F.interpolate(f(x), size, mode="bilinear",
                                      align_corners=True))
        return torch.cat(outs, dim=1)


class DotCls(nn.Conv2d):
    """Plain 1x1-conv classifier (its weight is ``classifier.weight``)."""

    def __init__(self, in_dim: int = 512, n_classes: int = 2):
        super().__init__(in_dim, n_classes, kernel_size=1, bias=False)


class PSPNet(nn.Module):
    """Dilated ResNet + PPM + bottleneck + dot classifier."""

    def __init__(self, layers: int = 50, bins: Sequence[int] = (1, 2, 3, 6),
                 dropout: float = 0.1, bottleneck_dim: int = 512,
                 num_classes_tr: int = 2):
        super().__init__()
        trunk = DilatedResNet(layers)
        # the reference's attribute names: the trunk's stages hang off the
        # PSPNet itself (src/model/pspnet.py:96-101)
        self.layer0, self.layer1, self.layer2 = trunk.layer0, trunk.layer1, trunk.layer2
        self.layer3, self.layer4 = trunk.layer3, trunk.layer4
        fea_dim = 2048
        self.ppm = PPM(fea_dim, fea_dim // len(bins), tuple(bins))
        self.bottleneck = nn.Sequential(
            nn.Conv2d(fea_dim * 2, bottleneck_dim, kernel_size=3, padding=1,
                      bias=False),
            nn.BatchNorm2d(bottleneck_dim),
            nn.ReLU(inplace=True),
            nn.Dropout2d(p=dropout),
        )
        self.classifier = DotCls(bottleneck_dim, num_classes_tr)
        self.gamma = nn.Parameter(torch.tensor(0.2))

    def extract_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) NHWC images -> (B, h, w, 512) NHWC features."""
        x = x.permute(0, 3, 1, 2).contiguous()
        for stage in (self.layer0, self.layer1, self.layer2, self.layer3,
                      self.layer4):
            x = stage(x)
        x = self.bottleneck(self.ppm(x))
        return x.permute(0, 2, 3, 1).contiguous()


def build_pspnet(cfg, generator: Optional[torch.Generator] = None) -> PSPNet:
    """PSPNet from a flat config, with a seeded random init.

    The port runs the fp32 ResNet/dot configuration only; VGG, the cosine
    classifiers and the bf16 stage policy raise.
    """
    if cfg.get("arch", "resnet") != "resnet":
        raise NotImplementedError(f"arch {cfg.arch!r}: the port runs resnet only")
    if cfg.get("dist", "dot") != "dot" or str(cfg.get("cls_type", "oooo"))[:1] == "r":
        raise NotImplementedError(
            f"dist {cfg.get('dist')!r} / cls_type {cfg.get('cls_type')!r}: "
            "the port runs the plain dot classifier only")
    if (str(cfg.get("compute_dtype", "float32")) != "float32"
            or cfg.get("use_amp", False) or cfg.get("bf16_stages")):
        raise NotImplementedError("the port runs fp32 only (no bf16 policy)")
    if cfg.get("rmid") or cfg.get("inherit_base", False):
        raise NotImplementedError("rmid / inherit_base are not ported")
    model = PSPNet(layers=cfg.layers, bins=tuple(cfg.bins), dropout=cfg.dropout,
                   bottleneck_dim=cfg.bottleneck_dim,
                   num_classes_tr=cfg.num_classes_tr)
    if generator is None:
        generator = torch.Generator().manual_seed(int(cfg.get("manual_seed") or 0))
    reset_parameters(model, generator)
    nn.init.kaiming_uniform_(model.classifier.weight, a=math.sqrt(5),
                             generator=generator)
    return model
