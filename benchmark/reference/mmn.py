"""Plain math of the MMN head's meta-training step (the reference's
``src/train_ddp.py`` with ``src/model/mmn.py``, ``src/model/match.py`` and
``src/model/conv4d.py``), in fp32, on the features of ``pspnet``.

For each episode: the cosine correlation (Q = S = h * w) of the query's and
the support's last block of each stage in ``rmid`` (stages reversed, one
channel each), the mutual-max normalisation (eps 1e-5), a symmetric
neighbourhood consensus of centre-pivot 4D conv blocks with ReLU (each
block a 3x3 conv over the query plane plus one over the support plane,
each with its bias; the swapped stack applies them the other way round),
the mutual-max normalisation again, a softmax over the support at
temperature ``temp`` reading out the support's bottleneck features, the
adapted classifier on that readout upsampled to the label (bilinear, align
corners), and the dice loss of its sigmoid (each image row one item, as the
reference's ``SegLoss`` takes an unbatched map). The step's loss is the
mean over episodes; SGD with momentum, Nesterov and weight decay (torch's
rule) on the head's parameters.

The volume is held as (B, Q, S, C); each plane conv runs as a batched 2D
conv over the other plane's positions.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from .cwt import logits_up
from .precision import conv2d, matmul
from .pspnet import Entry, fan_in_uniform


def consensus_schema(in_channel: int, channels: Sequence[int] = (10, 10, 1)) -> List[Entry]:
    """The head's parameters: every block's two 3x3 kernels U(+-1/sqrt(fan_in))
    and zero biases (``calibrate_consensus`` sets the biases)."""
    out, ci = [], in_channel
    for i, co in enumerate(channels):
        for conv in ("conv1", "conv2"):
            p = f"corr_net.NeighConsensus.conv.{2 * i}.{conv}"
            out.append(fan_in_uniform(f"{p}.weight", (co, ci, 3, 3)))
            out.append((f"{p}.bias", (co,), "const", 0.0))
        ci = co
    return out


@torch.no_grad()
def calibrate_consensus(p: Dict[str, torch.Tensor], corr: torch.Tensor, dims,
                        n_blocks: int = 3) -> None:
    """Set each block's ``conv1`` bias (``conv2``'s stays 0) to the negated
    per-channel median of its pre-activation on ``corr`` (B, Q, S, C) after
    mutual matching, block after block of the unswapped stack, so that half
    of each block's outputs are live, as in a trained consensus."""
    x = mutual(corr)
    for i in range(n_blocks):
        pre_fix = f"corr_net.NeighConsensus.conv.{2 * i}"
        p[f"{pre_fix}.conv1.bias"].zero_()
        p[f"{pre_fix}.conv2.bias"].zero_()
        pre = (plane_conv(x, p[f"{pre_fix}.conv1.weight"], p[f"{pre_fix}.conv1.bias"], dims,
                          over_query=True)
               + plane_conv(x, p[f"{pre_fix}.conv2.weight"], p[f"{pre_fix}.conv2.bias"], dims,
                            over_query=False))
        med = pre.flatten(0, 2).median(dim=0).values
        p[f"{pre_fix}.conv1.bias"].copy_(-med)
        x = torch.relu(pre - med)


def cosine_corr(fq: torch.Tensor, fs: torch.Tensor) -> torch.Tensor:
    """(B, h, w, C) x (B, h, w, C) -> (B, Q, S) cosine similarities."""
    b, c = fq.shape[0], fq.shape[-1]
    q = fq.reshape(b, -1, c)
    s = fs.reshape(b, -1, c)
    q = q / q.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    s = s / s.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    return matmul(q, s.transpose(1, 2))


def mutual(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(B, Q, S, C) mutual-max normalisation per channel."""
    max_s = x.amax(dim=2, keepdim=True)
    max_q = x.amax(dim=1, keepdim=True)
    return x * ((x / (max_s + eps)) * (x / (max_q + eps)))


def plane_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               dims, over_query: bool) -> torch.Tensor:
    """A 3x3 conv over the query plane (``over_query``) or the support plane
    of (B, Q, S, C), batched over the other plane."""
    hq, wq, hs, ws = dims
    b, q, s, c = x.shape
    if over_query:
        t = x.permute(0, 2, 3, 1).reshape(b * s, c, hq, wq)
        out = conv2d(t, weight, bias, padding=1)
        return out.reshape(b, s, -1, q).permute(0, 3, 1, 2)
    t = x.permute(0, 1, 3, 2).reshape(b * q, c, hs, ws)
    out = conv2d(t, weight, bias, padding=1)
    return out.reshape(b, q, -1, s).permute(0, 1, 3, 2)


def pivot_block(x, p: Dict[str, torch.Tensor], prefix: str, dims, swapped: bool):
    """ReLU(conv1 over one plane + conv2 over the other), (B, Q, S, C)."""
    w1, b1 = p[f"{prefix}.conv1.weight"], p[f"{prefix}.conv1.bias"]
    w2, b2 = p[f"{prefix}.conv2.weight"], p[f"{prefix}.conv2.bias"]
    return torch.relu(plane_conv(x, w1, b1, dims, over_query=not swapped)
                      + plane_conv(x, w2, b2, dims, over_query=swapped))


def consensus(x, p, dims, n_blocks: int = 3):
    """Symmetric stack: stack(x) + swapped stack(x)."""
    out = []
    for swapped in (False, True):
        y = x
        for i in range(n_blocks):
            y = pivot_block(y, p, f"corr_net.NeighConsensus.conv.{2 * i}", dims, swapped)
        out.append(y)
    return out[0] + out[1]


def readout(corr2d: torch.Tensor, values: torch.Tensor, temp: float) -> torch.Tensor:
    """softmax over the support of corr * temp, times (B, S, C) values."""
    return matmul(torch.softmax(corr2d * temp, dim=-1), values)


def dice_loss(logits: torch.Tensor, label: torch.Tensor, eps: float = 1e-8):
    """(K=2, H, W) logits: the binary dice of the sigmoid per class plane,
    each of the H rows one item, summed over items and planes / H."""
    tgt = torch.stack([(label == 0).float(), (label == 1).float()])      # (2, H, W)
    pred = torch.sigmoid(logits.float())
    num = (pred * tgt).sum(-1)                                           # (2, H)
    den = (pred ** 2).sum(-1) + (tgt ** 2).sum(-1)
    return (1.0 - 2.0 * num / den.clamp(min=eps)).sum() / label.shape[0]


def volume(taps_q: Dict[int, torch.Tensor], taps_s: Dict[int, torch.Tensor],
           bids: Sequence[int]) -> torch.Tensor:
    """(B, Q, S, L): one cosine correlation a stage, stages reversed."""
    return torch.stack([cosine_corr(taps_q[b], taps_s[b]) for b in reversed(bids)], -1)


def episode_loss(p, taps_q: Dict[int, torch.Tensor], taps_s: Dict[int, torch.Tensor],
                 f_s: torch.Tensor, w: torch.Tensor, q_label: torch.Tensor,
                 bids: Sequence[int], temp: float, n_blocks: int = 3) -> torch.Tensor:
    """One 1-shot episode's loss: taps (1, h', w', C'), f_s (1, h, w, 512),
    w (2, 512), q_label (H, W)."""
    _, h, wd, c = f_s.shape
    dims = (h, wd, h, wd)
    filt = mutual(consensus(mutual(volume(taps_q, taps_s, bids)), p, dims, n_blocks))[..., 0]
    att = readout(filt, f_s.reshape(1, -1, c), temp).reshape(1, h, wd, c)
    return dice_loss(logits_up(w[None], att, q_label.shape[-2:])[0], q_label)


def sgd_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             bufs: Dict[str, torch.Tensor], lr: float, momentum: float,
             weight_decay: float) -> None:
    """torch's SGD with momentum, dampening 0, Nesterov, in place."""
    for k, p in params.items():
        d = grads[k] + weight_decay * p
        bufs[k] = d.clone() if k not in bufs else momentum * bufs[k] + d
        params[k] = p - lr * (d + momentum * bufs[k])
