"""Dilated deep-stem ResNet backbone (PyTorch).

Counterpart of ``few_shot_seg_cwt_tpu.models.resnet``: ResNet-50/101 with

* the PSPNet "deep base" stem: three 3x3 convs 3->64->64->128 (BN, ReLU)
  and a 3x3 stride-2 max-pool, held as ``layer0`` with the reference's
  Sequential indices (conv ``0, 3, 6``, BN ``1, 4, 7``);
* layer3 with dilation 2 and layer4 with dilation 4, both stride 1, so the
  output stride is 8 (60x60 features at 473 px);
* ``BatchNorm2d``: eps 1e-5, momentum 0.1, run on its running statistics
  in eval mode; in train mode (stage-1 pretraining) it normalises with the
  batch statistics and updates the running variance with the biased batch
  variance, as flax's ``nn.BatchNorm`` does; inside a process group
  (``parallel.mesh``) the batch is the global one of every rank (SyncBN).

Parameter names are the reference repo's (``layerN.i.convK`` / ``bnK`` /
``downsample.{0,1}``), so a reference state_dict loads with
``load_state_dict``. Tensors are NCHW inside the module.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.mesh import active, all_reduce_sum, gather_rows

# block counts per stage (reference: src/model/resnet.py:198,210)
RESNET_DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch norm over the global batch of every rank (SyncBN).

    Forward: each rank's per-channel count, mean and sum of squared
    deviations (two passes over its slice) are gathered by one all-reduce
    and combined in rank order (Chan's update), so every rank normalises
    with the same global mean and biased variance; that is the statistic
    flax computes over a batch sharded on a mesh. Backward: the two
    per-channel sums of the input gradient (Σdy, Σdy·x̂) are all-reduced,
    since every rank's normalisation depends on every rank's inputs; the
    weight and bias gradients stay this rank's sums, and the trainer's
    gradient all-reduce averages them with the rest. The per-channel sums
    accumulate in float64 (as torch's CPU batch norm does), so the
    statistics do not depend on how the batch is split or ordered beyond
    the last rounding."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        dims = (0, 2, 3)
        n = torch.full((x.shape[1],), x.numel() // x.shape[1], dtype=torch.float64,
                       device=x.device)
        mean = x.sum(dims, dtype=torch.float64) / n
        m2 = ((x.double() - mean[None, :, None, None]) ** 2).sum(dims)
        stats = gather_rows(torch.stack([n, mean, m2])[None])
        n_all, mean, m2 = stats[0, 0], stats[0, 1], stats[0, 2]
        for r in range(1, stats.shape[0]):
            n_r, mean_r, m2_r = stats[r]
            total = n_all + n_r
            delta = mean_r - mean
            mean = mean + delta * (n_r / total)
            m2 = m2 + m2_r + delta * delta * (n_all * n_r / total)
            n_all = total
        var = m2 / n_all
        mean, var = mean.to(x.dtype), var.to(x.dtype)
        invstd = torch.rsqrt(var + eps)
        xhat = (x - mean[None, :, None, None]) * invstd[None, :, None, None]
        ctx.save_for_backward(xhat, weight, invstd, n_all)
        ctx.mark_non_differentiable(mean, var)
        return xhat * weight[None, :, None, None] + bias[None, :, None, None], mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, weight, invstd, n_all = ctx.saved_tensors
        dims = (0, 2, 3)
        sum_dy = dy.sum(dims, dtype=torch.float64)
        sum_dy_xhat = (dy.double() * xhat).sum(dims)
        total = all_reduce_sum(torch.stack([sum_dy, sum_dy_xhat]))
        mean_dy = (total[0] / n_all).to(dy.dtype)
        mean_dy_xhat = (total[1] / n_all).to(dy.dtype)
        scale = (weight * invstd)[None, :, None, None]
        dx = scale * (dy - mean_dy[None, :, None, None] - xhat * mean_dy_xhat[None, :, None, None])
        return dx, sum_dy_xhat.to(weight.dtype), sum_dy.to(weight.dtype), None


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose running variance follows flax's update, with
    global-batch statistics under a process group.

    In train mode torch folds the *unbiased* batch variance into
    ``running_var`` and flax the *biased* one; the output (normalised with
    the biased variance) is the same. torch updates copies of the running
    statistics here, and the buffers take its mean and, for the variance,
    flax's value: with factor f, n values a channel and v_old the previous
    statistic, torch's copy holds (1-f) v_old + f v n/(n-1) and flax's is
    (1-f) v_old + f v = copy (n-1)/n + (1-f) v_old / n. The copies keep the
    buffers out of autograd's saved tensors, which an in-place update after
    the op would invalidate. Eval mode is ``nn.BatchNorm2d`` itself.

    In train mode inside a process group (``parallel.mesh``) the statistics
    are the global batch's (``_GlobalBatchNorm``: the PPM's bin-1 branch
    has one value an image and channel, so a rank's slice alone would give
    other statistics), and the running statistics take the global mean and
    biased variance, as flax's update does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        f = (self.momentum if self.momentum is not None
             else 1.0 / float(self.num_batches_tracked))
        if active():
            out, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps)
            with torch.no_grad():
                self.running_mean.mul_(1.0 - f).add_(mean, alpha=f)
                self.running_var.mul_(1.0 - f).add_(var, alpha=f)
            return out
        mean, var = self.running_mean.clone(), self.running_var.clone()
        out = F.batch_norm(x, mean, var, self.weight, self.bias, True, f, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.copy_(mean)
            self.running_var.mul_(1.0 - f).div_(n).add_(var, alpha=(n - 1) / n)
        return out


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
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = conv(planes, planes, 3, stride, dilation)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = conv(planes, planes * 4, 1)
        self.bn3 = BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample: Optional[nn.Sequential] = None
        if has_downsample:
            self.downsample = nn.Sequential(
                conv(in_ch, planes * 4, 1, stride), BatchNorm2d(planes * 4))

    def forward(self, x: torch.Tensor, return_pre_relu: bool = False):
        """The block's output; with ``return_pre_relu`` also the sum before
        the last ReLU (the ``rmid nr`` tap). An input rounded to another
        dtype than the parameters' (``stage_cast`` under
        ``stage_round_only``) is promoted per branch, as flax does."""
        dtype = self.conv1.weight.dtype
        out = self.relu(self.bn1(self.conv1(x.to(dtype))))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x.to(dtype))
        pre = out + residual
        if return_pre_relu:
            return torch.relu(pre), pre
        return self.relu(pre)


class DilatedResNet(nn.Module):
    """Deep-stem dilated ResNet trunk: (N, 3, H, W) -> (N, 2048, H/8, W/8)."""

    arch = "resnet"

    def __init__(self, depth: int = 50):
        super().__init__()
        self.layer0 = nn.Sequential(
            conv(3, 64, 3, 2), BatchNorm2d(64), nn.ReLU(inplace=True),
            conv(64, 64, 3), BatchNorm2d(64), nn.ReLU(inplace=True),
            conv(64, 128, 3), BatchNorm2d(128), nn.ReLU(inplace=True),
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


def run_trunk(trunk: nn.Module, x: torch.Tensor, return_feats: bool = False,
              no_relu: bool = False):
    """``trunk.layer0..layer4`` (a DilatedResNet or VGG16BN, or a PSPNet that
    holds the stages itself): (N, 3, H, W) -> (N, 2048, H/8, W/8) for the
    ResNet, (N, 512, ~H/16, ~W/16) for VGG; with ``return_feats`` also
    ``feats[stage]`` for stages 1..4 (NCHW), as the JAX trunk returns them:
    the ResNet's block outputs, VGG's stage output, and with ``no_relu``
    ``feats["nr"]``, the ResNet's layer4 output before its last ReLU (the
    JAX ``Bottleneck.return_pre_relu``). Under a stage dtype policy the
    input of the stem and of each stage is cast to that stage's dtype."""
    x = trunk.layer0(stage_cast(trunk, x, "stem"))
    per_block = trunk.arch == "resnet"
    feats = {}
    for stage in range(1, 5):
        x = stage_cast(trunk, x, f"layer{stage}")
        layer = getattr(trunk, f"layer{stage}")
        if not per_block:
            x = layer(x)
            feats[stage] = [x]
            continue
        outs = []
        for i, block in enumerate(layer):
            if no_relu and stage == 4 and i == len(layer) - 1:
                x, pre = block(x, return_pre_relu=True)
                feats["nr"] = [pre]
            else:
                x = block(x)
            if return_feats:  # held only where a head reads them
                outs.append(x)
        feats[stage] = outs
    return (x, feats) if return_feats else x


def stage_cast(model: nn.Module, x: torch.Tensor, stage: str) -> torch.Tensor:
    """``x`` in the compute dtype of ``stage`` under ``model.stage_dtypes``
    (``models.pspnet.cast_backbone``); unchanged without a policy. Under
    ``stage_round_only`` (``models.pspnet.stage_boundary_casts``) it is
    rounded to that dtype, and each layer that reads it promotes it back to
    its parameters' dtype (fp32; float64 in the tests' double model), as a
    flax layer promotes a bf16 input: a ResNet stage's first ``Bottleneck``
    does that per branch, so the gradient is rounded per branch and summed
    in bf16, as JAX's transposed casts do; the stem, PPM and bottleneck
    inputs are promoted back here, once."""
    dtypes = getattr(model, "stage_dtypes", None)
    if dtypes is None:
        return x
    if getattr(model, "stage_round_only", False):
        rounded = x.to(dtypes[stage])
        return rounded if stage.startswith("layer") else rounded.to(x.dtype)
    return x.to(dtypes[stage])


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded torch-default init: kaiming-normal (fan_out) for conv kernels
    and zero conv biases (VGG's convs have them), unit/zero BN affine and
    zero/unit running stats."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                    nonlinearity="relu", generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            m.reset_running_stats()
