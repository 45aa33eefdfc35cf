from .resnet import RESNET_DEPTHS, Bottleneck, DilatedResNet
from .pspnet import (
    PPM,
    DotCls,
    PSPNet,
    apply_classifier,
    build_pspnet,
    init_classifier_weights,
)
from .cwt import MultiHeadAttentionOne, build_cwt
from .conv4d import CenterPivotConv4d
from .matching import MatchNet, NeighConsensus
from .msm import WeightAverage
from .mmn import MMN, build_mmn

__all__ = [
    "RESNET_DEPTHS",
    "Bottleneck",
    "DilatedResNet",
    "PPM",
    "DotCls",
    "PSPNet",
    "apply_classifier",
    "build_pspnet",
    "init_classifier_weights",
    "MultiHeadAttentionOne",
    "build_cwt",
    "CenterPivotConv4d",
    "MatchNet",
    "NeighConsensus",
    "WeightAverage",
    "MMN",
    "build_mmn",
]
