"""Plain ResNet-50 dilated PSPNet feature extractor, written from the
published description (Zhao et al., CVPR 2017, with the PSPNet "deep base"
stem; the few-shot references' ``src/model/pspnet.py``): torch's functional
ops on a ``state_dict`` whose names are the original PyTorch repository's.

* stem: three 3x3 convs 3->64->64->128 (the first stride 2), BN, ReLU, and
  a 3x3 stride-2 max-pool;
* four stages of bottleneck blocks (1x1, 3x3, 1x1 x4, projection shortcut
  on the first block), layer2 stride 2, layer3 dilation 2 and layer4
  dilation 4 at stride 1: output stride 8;
* the pyramid pooling module: adaptive average pools to bins 1, 2, 3, 6,
  each through a 1x1 conv, BN, ReLU and an align-corners bilinear upsample,
  concatenated with its input;
* the bottleneck: 3x3 conv to 512, BN, ReLU.

BN runs on its running statistics (eval), or with ``calibrate`` on the
batch's own statistics, which it writes into the ``state_dict`` (the
benchmark's calibration of seeded weights). Images and features are NHWC.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .precision import conv2d

DEPTHS = {50: (3, 4, 6, 3)}
# (planes, first-block stride, dilation) per stage
STAGES = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))
BINS = (1, 2, 3, 6)


Entry = Tuple[str, Tuple[int, ...], str, float]


def he(name: str, shape: Tuple[int, ...]) -> Entry:
    """A conv kernel drawn normal with std sqrt(2 / fan_out) (He, fan out)."""
    fan_out = shape[0] * math.prod(shape[2:])
    return (name, shape, "normal", math.sqrt(2.0 / fan_out))


def fan_in_uniform(name: str, shape: Tuple[int, ...]) -> Entry:
    """A kernel drawn U(+-1/sqrt(fan_in)) (torch's default conv bound)."""
    return (name, shape, "uniform", 1.0 / math.sqrt(math.prod(shape[1:])))


def _bn_names(prefix: str, ch: int) -> List[Entry]:
    return [(f"{prefix}.weight", (ch,), "const", 1.0), (f"{prefix}.bias", (ch,), "const", 0.0),
            (f"{prefix}.running_mean", (ch,), "const", 0.0),
            (f"{prefix}.running_var", (ch,), "const", 1.0),
            (f"{prefix}.num_batches_tracked", (), "count", 0.0)]


def schema(layers: int = 50, bottleneck_dim: int = 512, num_classes: int = 2,
           weight_norm_classifier: bool = False) -> List[Entry]:
    """(name, shape, distribution, scale) of every entry of the state_dict:
    ``normal`` (std), ``uniform`` (bound), ``const`` (value) or ``count``
    (an int64 0). The classifier and ``gamma`` are the repository's names;
    the episodes never read them."""
    out = []
    stem = [(3, 64), (64, 64), (64, 128)]
    for i, (ci, co) in enumerate(stem):
        out.append(he(f"layer0.{3 * i}.weight", (co, ci, 3, 3)))
        out += _bn_names(f"layer0.{3 * i + 1}", co)
    in_ch = 128
    for s, ((planes, _, _), n) in enumerate(zip(STAGES, DEPTHS[layers]), start=1):
        for b in range(n):
            p = f"layer{s}.{b}"
            out.append(he(f"{p}.conv1.weight", (planes, in_ch, 1, 1)))
            out += _bn_names(f"{p}.bn1", planes)
            out.append(he(f"{p}.conv2.weight", (planes, planes, 3, 3)))
            out += _bn_names(f"{p}.bn2", planes)
            out.append(he(f"{p}.conv3.weight", (planes * 4, planes, 1, 1)))
            out += _bn_names(f"{p}.bn3", planes * 4)
            if b == 0:
                out.append(he(f"{p}.downsample.0.weight", (planes * 4, in_ch, 1, 1)))
                out += _bn_names(f"{p}.downsample.1", planes * 4)
            in_ch = planes * 4
    red = in_ch // len(BINS)
    for j in range(len(BINS)):
        out.append(he(f"ppm.features.{j}.1.weight", (red, in_ch, 1, 1)))
        out += _bn_names(f"ppm.features.{j}.2", red)
    out.append(he("bottleneck.0.weight", (bottleneck_dim, 2 * in_ch, 3, 3)))
    out += _bn_names("bottleneck.1", bottleneck_dim)
    if weight_norm_classifier:
        out.append(("classifier.weight_g", (num_classes, 1, 1, 1), "const", 1.0))
        out.append(fan_in_uniform("classifier.weight_v", (num_classes, bottleneck_dim, 1, 1)))
    else:
        out.append(fan_in_uniform("classifier.weight", (num_classes, bottleneck_dim, 1, 1)))
    out.append(("gamma", (), "const", 0.2))
    return out


def _bn(x: torch.Tensor, sd: Dict[str, torch.Tensor], prefix: str,
        calibrate: bool) -> torch.Tensor:
    if calibrate:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        sd[f"{prefix}.running_mean"].copy_(mean)
        sd[f"{prefix}.running_var"].copy_(var)
    return F.batch_norm(x, sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"],
                        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"], False, 0.0, 1e-5)


def _block(x, sd, p, stride, dilation, calibrate):
    out = torch.relu(_bn(conv2d(x, sd[f"{p}.conv1.weight"]), sd, f"{p}.bn1", calibrate))
    out = torch.relu(_bn(conv2d(out, sd[f"{p}.conv2.weight"], stride=stride,
                                padding=dilation, dilation=dilation), sd, f"{p}.bn2",
                         calibrate))
    out = _bn(conv2d(out, sd[f"{p}.conv3.weight"]), sd, f"{p}.bn3", calibrate)
    if f"{p}.downsample.0.weight" in sd:
        x = _bn(conv2d(x, sd[f"{p}.downsample.0.weight"], stride=stride), sd,
                f"{p}.downsample.1", calibrate)
    return torch.relu(out + x)


@torch.no_grad()
def features(sd: Dict[str, torch.Tensor], images: torch.Tensor, layers: int = 50,
             taps=(), calibrate: bool = False):
    """(N, H, W, 3) images -> (N, h, w, 512) bottleneck features, and
    {stage: (N, h, w, C)} the last block's output of each stage in ``taps``."""
    x = images.permute(0, 3, 1, 2).contiguous()
    for i in range(3):
        x = conv2d(x, sd[f"layer0.{3 * i}.weight"], stride=2 if i == 0 else 1, padding=1)
        x = torch.relu(_bn(x, sd, f"layer0.{3 * i + 1}", calibrate))
    x = F.max_pool2d(x, 3, 2, 1)
    tapped = {}
    for s, ((_, stride, dilation), n) in enumerate(zip(STAGES, DEPTHS[layers]), start=1):
        for b in range(n):
            x = _block(x, sd, f"layer{s}.{b}", stride if b == 0 else 1, dilation, calibrate)
        if s in taps:
            tapped[s] = x.permute(0, 2, 3, 1)
    size = x.shape[-2:]
    pooled = [x]
    for j, b in enumerate(BINS):
        y = conv2d(F.adaptive_avg_pool2d(x, b), sd[f"ppm.features.{j}.1.weight"])
        y = torch.relu(_bn(y, sd, f"ppm.features.{j}.2", calibrate))
        pooled.append(F.interpolate(y, size, mode="bilinear", align_corners=True))
    x = conv2d(torch.cat(pooled, dim=1), sd["bottleneck.0.weight"], padding=1)
    x = torch.relu(_bn(x, sd, "bottleneck.1", calibrate))
    return x.permute(0, 2, 3, 1).contiguous(), tapped
