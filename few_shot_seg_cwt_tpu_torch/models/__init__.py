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
from .conv4d import CenterPivotConv4d, Conv4d, conv4d
from .matching import MatchNet, NeighConsensus, SpatialContextEncoder
from .msm import MSBlock, WeightAverage
from .mmn import MMN, build_mmn
from .chm import CHM4d, CHM6d, CHMLearner
from .deform import DeformAtt, MSDeformAttn, grid_sample_bilinear, sine_positional_encoding
from .detr import DeTr, build_detr
from .att_zoo import MHA, AttentionBlock, CrossAttention, LinearDiag, build_attention_variant
from .fusion import DynamicFusion, FuseNet, FuseNet1

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
    "Conv4d",
    "conv4d",
    "MatchNet",
    "NeighConsensus",
    "SpatialContextEncoder",
    "MSBlock",
    "WeightAverage",
    "MMN",
    "build_mmn",
    "CHM4d",
    "CHM6d",
    "CHMLearner",
    "DeformAtt",
    "MSDeformAttn",
    "grid_sample_bilinear",
    "sine_positional_encoding",
    "DeTr",
    "build_detr",
    "CrossAttention",
    "MHA",
    "AttentionBlock",
    "LinearDiag",
    "build_attention_variant",
    "DynamicFusion",
    "FuseNet",
    "FuseNet1",
]
