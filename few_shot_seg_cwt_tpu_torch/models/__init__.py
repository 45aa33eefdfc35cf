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
]
