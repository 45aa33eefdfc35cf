"""PSPNet feature extractor and classifiers (PyTorch).

Counterpart of ``few_shot_seg_cwt_tpu.models.pspnet``:

* trunk: the dilated ResNet (``arch resnet``, 2048 channels at stride 8) or
  VGG-16bn (``arch vgg``, 512 channels at stride 16);
* Pyramid Pooling Module: adaptive-avg-pool to bins [1, 2, 3, 6] -> 1x1
  conv + BN + ReLU -> bilinear (align_corners) upsample -> concat;
* bottleneck: 3x3 conv -> 512 + BN + ReLU + channel dropout;
* classifiers (``dist``, ``cls_type``): ``DotCls``, the plain 1x1 conv, or
  its weight-norm form (``cls_type r***``), and ``CosCls``, the cosine
  classifier with the 4-character flags of ``parse_cls_type``;
* ``extract_features`` takes and returns NHWC, like the JAX package;
  ``forward`` classifies and zooms the logits to (h - 1) // 8 * 8 + 1
  (align corners), the JAX ``__call__``;
* the per-stage dtype policy (``stage_dtype_policy``: ``compute_dtype
  bfloat16`` or ``use_amp`` casts the whole backbone to bf16, ``bf16_stages``
  only the listed stages): ``cast_backbone`` casts each stage's parameters
  and BN buffers and installs the activation casts at the stage boundaries
  (stem, layer1-4, ppm, bottleneck), the JAX ``_stage_cast``. It is an
  explicit cast of the module, not ``torch.autocast``, which would keep BN
  and other layers in fp32: a different function from the JAX one.

Every BN is ``resnet.BatchNorm2d``: in train mode (stage-1 pretraining) its
running variance follows flax's update. Module and parameter names are the
reference repo's (``layer0..layer4``, ``ppm.features.i.{1,2}``,
``bottleneck.{0,1}``, ``classifier.weight`` or ``classifier.weight_g`` /
``weight_v``, ``classifier.cls.*`` and ``classifier.scale_factor`` for the
cosine classifier, ``gamma``), so ``utils.convert`` carries flax variables
across by name and a reference ``.pth`` loads with ``load_state_dict``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import upsample_bilinear_ac
from ..parallel.mesh import rank_world
from .cwt import dropout
from .resnet import BatchNorm2d, DilatedResNet, reset_parameters, run_trunk, stage_cast
from .vgg import VGG16BN

# backbone stages addressable by the per-stage dtype policy
BACKBONE_STAGES = ("stem", "layer1", "layer2", "layer3", "layer4",
                   "ppm", "bottleneck")


def stage_dtype_policy(cfg) -> Dict[str, torch.dtype]:
    """Per-stage backbone compute dtype {stage: torch dtype}.

    ``compute_dtype bfloat16`` (or the reference's ``use_amp``) runs every
    stage in bf16, the whole-backbone cast. With fp32 compute,
    ``bf16_stages`` ("all" or a comma list of ``BACKBONE_STAGES``, e.g.
    "stem,layer1,layer2") runs only the listed stages in bf16. An unknown
    stage or compute dtype raises.
    """
    compute = str(cfg.get("compute_dtype", "float32"))
    if compute not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {compute!r}: 'float32' or 'bfloat16'")
    if compute == "bfloat16" or cfg.get("use_amp", False):
        return {s: torch.bfloat16 for s in BACKBONE_STAGES}
    sel = cfg.get("bf16_stages", None)
    if not sel:
        return {s: torch.float32 for s in BACKBONE_STAGES}
    chosen = (set(BACKBONE_STAGES) if str(sel) == "all"
              else {s.strip() for s in str(sel).split(",") if s.strip()})
    unknown = chosen - set(BACKBONE_STAGES)
    if unknown:
        raise ValueError(f"bf16_stages: unknown stages {sorted(unknown)}; the stages "
                         f"are {BACKBONE_STAGES}")
    if cfg.get("arch", "resnet") != "resnet":
        raise ValueError("bf16_stages: the per-stage policy is defined for the resnet "
                         "trunk only, as in the JAX package")
    return {s: (torch.bfloat16 if s in chosen else torch.float32) for s in BACKBONE_STAGES}


def policy_is_noop(policy: Dict[str, torch.dtype]) -> bool:
    return set(policy.values()) == {torch.float32}


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
    (E, K, C) weights x (E, h, w, C) features -> (E, h, w, K), in the
    promoted dtype of the two (bf16 meets fp32 in fp32, as in JAX).
    """
    dtype = torch.promote_types(weights.dtype, features.dtype)
    weights, features = weights.to(dtype), features.to(dtype)
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
                BatchNorm2d(reduction_dim),
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


def parse_cls_type(cls_type: str) -> Tuple[bool, bool, bool, bool]:
    """4-character flags: weight-norm reparameterisation (``r``), forward
    weight normalisation (``n``), bias (``b``), learnable temperature
    (``t``); ``o`` or ``0`` turns a flag off. Shorter strings are padded
    with ``o``, as the JAX package does for the 3-character ``ooo`` that
    published configs ship."""
    lut = {"r": True, "n": True, "b": True, "t": True, "0": False, "o": False}
    ct = (str(cls_type) + "oooo")[:4]
    if any(c not in lut for c in ct):
        raise ValueError(f"cls_type {cls_type!r}: characters from 'rnbt' (on) or "
                         "'o'/'0' (off)")
    return tuple(lut[c] for c in ct)  # type: ignore[return-value]


class DotCls(nn.Conv2d):
    """Plain 1x1-conv classifier (its weight is ``classifier.weight``)."""

    def __init__(self, in_dim: int = 512, n_classes: int = 2):
        super().__init__(in_dim, n_classes, kernel_size=1, bias=False)


class WeightNormConv1x1(nn.Module):
    """1x1 conv under the weight-norm reparameterisation w = g v / ||v||
    (the norm per output channel), held as ``weight_g`` (K, 1, 1, 1) and
    ``weight_v`` (K, C, 1, 1): the names ``torch.nn.utils.weight_norm``
    gives the reference's checkpoints. ``weight`` is the effective w."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = False):
        super().__init__()
        self.weight_g = nn.Parameter(torch.ones(out_dim, 1, 1, 1))
        self.weight_v = nn.Parameter(torch.empty(out_dim, in_dim, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if bias else None

    @property
    def weight(self) -> torch.Tensor:
        norm = self.weight_v.flatten(1).norm(dim=1).view(-1, 1, 1, 1)
        return self.weight_v * self.weight_g / norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias)


class CosCls(nn.Module):
    """Cosine classifier (reference: src/model/pspnet.py:290-312): the
    channel-normalised features against the (optionally normalised) class
    weights, plus an optional bias, times a scale (``scale_factor`` when
    learnable, else 2.0). Norms are clamped at 1e-5, as in the JAX package.
    NCHW in and out."""

    def __init__(self, in_dim: int = 512, n_classes: int = 2, cls_type: str = "oooo"):
        super().__init__()
        wn_reparam, self.weight_norm, use_bias, learn_temp = parse_cls_type(cls_type)
        self.cls = (WeightNormConv1x1(in_dim, n_classes, use_bias) if wn_reparam
                    else nn.Conv2d(in_dim, n_classes, kernel_size=1, bias=use_bias))
        if learn_temp:
            self.scale_factor = nn.Parameter(torch.tensor(2.0))
        else:
            self.scale_factor = 2.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.cls.weight
        if self.weight_norm:
            w = w / w.flatten(1).norm(dim=1).clamp(min=1e-5).view(-1, 1, 1, 1)
        x = x / x.norm(dim=1, keepdim=True).clamp(min=1e-5)
        return F.conv2d(x, w, self.cls.bias) * self.scale_factor


def build_classifier(dist: str, cls_type: str, in_dim: int, n_classes: int) -> nn.Module:
    """``dist dot``: ``DotCls``, or its weight-norm form for ``cls_type
    r***``; ``dist cos`` / ``cosN``: ``CosCls``."""
    if dist == "dot":
        if parse_cls_type(cls_type)[0]:
            return WeightNormConv1x1(in_dim, n_classes)
        return DotCls(in_dim, n_classes)
    if dist in ("cos", "cosN"):
        return CosCls(in_dim, n_classes, cls_type)
    raise ValueError(f"unknown dist {dist!r}: 'dot', 'cos' or 'cosN'")


def _conv1x1(classifier: nn.Module) -> nn.Module:
    return classifier.cls if isinstance(classifier, CosCls) else classifier


def effective_classifier_weight(model: "PSPNet") -> torch.Tensor:
    """The (K, C) weight the classifier applies: under the weight-norm form
    g v / ||v||, not the stored direction ``weight_v`` (the JAX
    ``effective_classifier_weight``). For the cosine classifier it is the
    weight before the forward's own normalisation, as in JAX."""
    return _conv1x1(model.classifier).weight[:, :, 0, 0]


def init_classifier(classifier: nn.Module, generator: torch.Generator) -> None:
    """torch Conv2d's default weight init (kaiming-uniform, a = sqrt(5))
    from ``generator``; the weight-norm form starts at g = ||v||, so its
    function is that of the plain weight; biases start at zero."""
    conv = _conv1x1(classifier)
    with torch.no_grad():
        if isinstance(conv, WeightNormConv1x1):
            nn.init.kaiming_uniform_(conv.weight_v, a=math.sqrt(5), generator=generator)
            conv.weight_g.copy_(conv.weight_v.flatten(1).norm(dim=1).view(-1, 1, 1, 1))
        else:
            nn.init.kaiming_uniform_(conv.weight, a=math.sqrt(5), generator=generator)
        if conv.bias is not None:
            conv.bias.zero_()


class PSPNet(nn.Module):
    """Dilated ResNet or VGG-16bn + PPM + bottleneck + classifier."""

    def __init__(self, layers: int = 50, bins: Sequence[int] = (1, 2, 3, 6),
                 dropout: float = 0.1, bottleneck_dim: int = 512,
                 num_classes_tr: int = 2, rmid: Optional[str] = None,
                 arch: str = "resnet", dist: str = "dot", cls_type: str = "oooo"):
        super().__init__()
        self.arch = arch
        self.rmid = rmid
        # {stage: dtype} of the activation casts; None: no casts (fp32)
        self.stage_dtypes: Optional[Dict[str, torch.dtype]] = None
        if arch == "resnet":
            trunk, fea_dim = DilatedResNet(layers), 2048
        elif arch == "vgg":
            trunk, fea_dim = VGG16BN(), 512
        else:
            raise ValueError(f"unknown arch {arch!r}: 'resnet' or 'vgg'")
        # the reference's attribute names: the trunk's stages hang off the
        # PSPNet itself (src/model/pspnet.py:96-101)
        self.layer0, self.layer1, self.layer2 = trunk.layer0, trunk.layer1, trunk.layer2
        self.layer3, self.layer4 = trunk.layer3, trunk.layer4
        self.ppm = PPM(fea_dim, fea_dim // len(bins), tuple(bins))
        self.bottleneck = nn.Sequential(
            nn.Conv2d(fea_dim * 2, bottleneck_dim, kernel_size=3, padding=1,
                      bias=False),
            BatchNorm2d(bottleneck_dim),
            nn.ReLU(inplace=True),
        )
        # the bottleneck's channel dropout (the reference's Dropout2d, which
        # holds no parameters), drawn from an explicit generator in _head
        self.dropout = dropout
        self.classifier = build_classifier(dist, cls_type, bottleneck_dim, num_classes_tr)
        self.gamma = nn.Parameter(torch.tensor(0.2))

    def extract_features(self, x: torch.Tensor,
                         generator: Optional[torch.Generator] = None):
        """(B, H, W, 3) NHWC images -> (B, h, w, 512) NHWC features.

        With ``rmid`` set (the matching heads), returns ``(features, feats)``
        with ``feats[stage]`` for stages 1..4 (and ``feats["nr"]``, layer4
        before its last ReLU, under ``rmid nr``), NHWC views, as the JAX
        package's ``extract_features`` does. In train mode the bottleneck's
        channel dropout draws its mask from ``generator``.
        """
        x = x.permute(0, 3, 1, 2).contiguous()
        if not self.rmid:
            return self._head(run_trunk(self, x), generator).permute(0, 2, 3, 1).contiguous()
        x, feats = run_trunk(self, x, return_feats=True, no_relu=self.rmid == "nr")
        feats = {k: [f.permute(0, 2, 3, 1) for f in v] for k, v in feats.items()}
        return self._head(x, generator).permute(0, 2, 3, 1).contiguous(), feats

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """(B, H, W, 3) NHWC images -> (B, H', W', K) NHWC logits, zoomed
        (align corners) to H' = (H - 1) // 8 * 8 + 1 and likewise W'; with
        ``rmid`` set, ``(logits, feats)``. The JAX ``PSPNet.__call__``."""
        size = ((x.shape[1] - 1) // 8 * 8 + 1, (x.shape[2] - 1) // 8 * 8 + 1)
        out = self.extract_features(x, generator)
        feat, feats = out if self.rmid else (out, None)
        logits = self.classifier(feat.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        logits = upsample_bilinear_ac(logits, size)
        return (logits, feats) if self.rmid else logits

    def _head(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
              ) -> torch.Tensor:
        """PPM + bottleneck on the trunk's NCHW output. The channel dropout
        (flax ``nn.Dropout`` broadcast over h and w) runs in train mode only,
        from ``generator``."""
        x = self.ppm(stage_cast(self, x, "ppm"))
        x = self.bottleneck(stage_cast(self, x, "bottleneck"))
        if self.training:
            # under a process group x is this rank's slice of the global batch
            x = dropout(x, self.dropout, generator, (x.shape[0], x.shape[1], 1, 1),
                        shard=rank_world())
        return x

    def stage_modules(self) -> Dict[str, nn.Module]:
        return {"stem": self.layer0, "layer1": self.layer1, "layer2": self.layer2,
                "layer3": self.layer3, "layer4": self.layer4, "ppm": self.ppm,
                "bottleneck": self.bottleneck}


def cast_backbone(model: PSPNet, policy: Dict[str, torch.dtype]) -> PSPNet:
    """Apply a stage dtype policy to ``model`` in place: every floating
    parameter and BN buffer of a stage goes to the stage's dtype, and the
    activations are cast at each stage boundary. ``classifier`` and
    ``gamma`` stay as they are (the episodic math is fp32). Uniform fp32
    leaves an fp32 model alone. Counterpart of the JAX ``cast_backbone_io``;
    the engines cast the output features back to fp32 themselves.

    A model already cast to another policy raises: casting bf16 weights
    back up would not give the fp32 model back, and leaving them would run
    another policy than the caller's. Give each engine its own copy."""
    policy = dict(policy)
    if (model.stage_dtypes or {s: torch.float32 for s in BACKBONE_STAGES}) == policy:
        return model
    if model.stage_dtypes is not None:
        raise ValueError(
            "cast_backbone: the backbone already runs the stage policy "
            f"{_policy_str(model.stage_dtypes)}, not {_policy_str(policy)}; pass each "
            "engine its own copy (copy.deepcopy) of the fp32 backbone")
    for stage, module in model.stage_modules().items():
        module.to(policy[stage])
    model.stage_dtypes = policy
    return model


def _policy_str(policy: Dict[str, torch.dtype]) -> str:
    return ",".join(f"{s}:{str(d).split('.')[-1]}" for s, d in policy.items())


def build_pspnet(cfg, generator: Optional[torch.Generator] = None) -> PSPNet:
    """PSPNet from a flat config, with a seeded random init, under the
    config's stage dtype policy (``cast_backbone``)."""
    policy = stage_dtype_policy(cfg)
    rmid = cfg.get("rmid") or None
    if cfg.get("inherit_base", False):
        raise NotImplementedError("inherit_base is not ported (ROADMAP queue 1 item 11)")
    model = PSPNet(layers=cfg.layers, bins=tuple(cfg.bins), dropout=cfg.dropout,
                   bottleneck_dim=cfg.bottleneck_dim,
                   num_classes_tr=cfg.num_classes_tr, rmid=rmid,
                   arch=cfg.get("arch", "resnet"), dist=cfg.get("dist", "dot"),
                   cls_type=str(cfg.get("cls_type", "oooo")))
    if generator is None:
        generator = torch.Generator().manual_seed(int(cfg.get("manual_seed") or 0))
    reset_parameters(model, generator)
    init_classifier(model.classifier, generator)
    return cast_backbone(model, policy)
