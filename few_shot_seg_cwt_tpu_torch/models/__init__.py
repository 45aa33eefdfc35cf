from .resnet import RESNET_DEPTHS, BatchNorm2d, Bottleneck, DilatedResNet
from .vgg import VGG16BN
from .pspnet import (
    PPM,
    CosCls,
    DotCls,
    PSPNet,
    WeightNormConv1x1,
    apply_classifier,
    build_pspnet,
    effective_classifier_weight,
    init_classifier_weights,
)
from .cwt import MultiHeadAttentionOne, build_cwt
from .conv4d import CenterPivotConv4d
from .matching import MatchNet, NeighConsensus
from .msm import WeightAverage
from .mmn import MMN, build_mmn

__all__ = [
    "RESNET_DEPTHS",
    "BatchNorm2d",
    "Bottleneck",
    "DilatedResNet",
    "VGG16BN",
    "PPM",
    "CosCls",
    "DotCls",
    "PSPNet",
    "WeightNormConv1x1",
    "apply_classifier",
    "build_pspnet",
    "effective_classifier_weight",
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
