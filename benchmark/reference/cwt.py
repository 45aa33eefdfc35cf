"""Plain episode math of the Classifier Weight Transformer (Lu et al., ICCV
2021, "Simpler is Better"; the reference's ``src/test.py`` and
``src/model/transformer.py``), in fp32, on the features of ``pspnet``.

* The inner loop: a fresh (K, C) 1x1 classifier trained by plain SGD for
  ``steps`` steps on the support features, with the class-weighted
  cross-entropy ([1, n_bg / n_fg], ignore 255, weighted mean) of its
  logits upsampled (bilinear, align corners) to the label's size, by
  autograd, every episode of a batch at once (their losses summed: each
  classifier sees only its own episode's gradient).
* The transformer: one attention block whose query is the classifier,
  keys and values the L2-normalised query features, with one shared
  bias-free projection, scaled by sqrt(d), then ``fc``, a residual and a
  LayerNorm (eps 1e-5); no dropout (eval).
* The tail: both classifiers (transformed on the normalised features, raw
  on the raw ones) upsampled to the label, argmax, per-class intersection
  and union (ignore 255), and the unweighted cross-entropy.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from .precision import einsum, matmul


def class_weights(label: torch.Tensor) -> torch.Tensor:
    """(E, ...) labels -> (E, 2) weights [1, n_bg / n_fg] of each episode."""
    flat = label.flatten(1)
    valid = flat != 255
    fg = (flat == 1).sum(1).float()
    bg = valid.sum(1).float() - fg
    return torch.stack([torch.ones_like(fg), bg / fg.clamp(min=1e-12)], dim=1)


def weighted_ce(logits: torch.Tensor, label: torch.Tensor, weights: torch.Tensor):
    """Per-episode weighted CE: logits (E, K, H, W), label (E, H, W),
    weights (E, K) -> (E,)."""
    valid = label != 255
    tgt = torch.where(valid, label, torch.zeros_like(label)).long()
    nll = -torch.log_softmax(logits.float(), dim=1).gather(1, tgt[:, None])[:, 0]
    w = torch.gather(weights, 1, tgt.flatten(1)).reshape(tgt.shape) * valid.float()
    return (nll * w).flatten(1).sum(1) / w.flatten(1).sum(1).clamp(min=1e-12)


def logits_up(w: torch.Tensor, feat: torch.Tensor, size) -> torch.Tensor:
    """(E, K, C) classifiers on (E, h, w, C) features -> (E, K, H, W)."""
    lg = einsum("ehwc,ekc->ekhw", feat, w)
    return F.interpolate(lg, tuple(size), mode="bilinear", align_corners=True)


def adapt(f_s: torch.Tensor, s_label: torch.Tensor, w0: torch.Tensor, steps: int,
          lr: float) -> torch.Tensor:
    """1-shot inner loop: f_s (E, h, w, C), s_label (E, H, W), w0 (E, K, C)."""
    cw = class_weights(s_label)
    w = w0.detach().clone()
    with torch.enable_grad():
        for _ in range(steps):
            w.requires_grad_(True)
            loss = weighted_ce(logits_up(w, f_s, s_label.shape[-2:]), s_label, cw).sum()
            (g,) = torch.autograd.grad(loss, w)
            w = (w - lr * g).detach()
    return w


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def transformer(sd: Dict[str, torch.Tensor], w: torch.Tensor, f_qn: torch.Tensor):
    """(E, K, C) classifier attending over (E, h, w, C) normalised features."""
    e, k, c = w.shape
    proj = sd["w_qkvs.weight"]
    q = matmul(w, proj.t())
    kv = matmul(f_qn.reshape(e, -1, c), proj.t())
    attn = torch.softmax(matmul(q, kv.transpose(1, 2)) / math.sqrt(proj.shape[0]), dim=-1)
    out = matmul(matmul(attn, kv), sd["fc.weight"].t()) + sd["fc.bias"]
    return F.layer_norm(out + w, (c,), sd["layer_norm.weight"], sd["layer_norm.bias"], 1e-5)


def predictions(sd_cwt, w: torch.Tensor, f_q: torch.Tensor, size):
    """Upsampled logits (E, K, H, W) of the transformed and the raw
    classifier."""
    f_qn = l2_normalize(f_q)
    w_upd = transformer(sd_cwt, w, f_qn)
    return logits_up(w_upd, f_qn, size), logits_up(w, f_q, size)


def iou(logits: torch.Tensor, label: torch.Tensor):
    """(E, K) intersection and union of the argmax against the label."""
    k = logits.shape[1]
    valid = label != 255
    pred = logits.argmax(1)
    inter = torch.stack([((pred == c) & (label == c) & valid).flatten(1).sum(1)
                         for c in range(k)], dim=1).float()
    area_p = torch.stack([((pred == c) & valid).flatten(1).sum(1) for c in range(k)], 1)
    area_t = torch.stack([((label == c) & valid).flatten(1).sum(1) for c in range(k)], 1)
    return inter, area_p.float() + area_t.float() - inter


def eval_metrics(sd_cwt, w: torch.Tensor, f_q: torch.Tensor, q_label: torch.Tensor):
    """The evaluation protocol's per-episode outputs."""
    pred, pred0 = predictions(sd_cwt, w, f_q, q_label.shape[-2:])
    ones = torch.ones(pred.shape[:2], device=pred.device)
    inter, union = iou(pred, q_label)
    inter0, union0 = iou(pred0, q_label)
    return {"inter": inter, "union": union, "inter0": inter0, "union0": union0,
            "loss": weighted_ce(pred, q_label, ones),
            "loss0": weighted_ce(pred0, q_label, ones)}


def serve_logit_gap(sd_cwt, w: torch.Tensor, f_q: torch.Tensor, size) -> torch.Tensor:
    """(E, H, W) foreground-minus-background logit of the transformed
    classifier: the served mask is where it is positive."""
    pred, _ = predictions(sd_cwt, w, f_q, size)
    return pred[:, 1] - pred[:, 0]


def transformer_schema(d: int = 512):
    """The transformer's parameters and their inits: the shared projection
    normal(0, sqrt(2 / (d + d))), ``fc`` xavier-normal with a U(+-1/sqrt(d))
    bias, a unit LayerNorm."""
    return [("w_qkvs.weight", (d, d), "normal", math.sqrt(2.0 / (2 * d))),
            ("fc.weight", (d, d), "normal", math.sqrt(2.0 / (2 * d))),
            ("fc.bias", (d,), "uniform", 1.0 / math.sqrt(d)),
            ("layer_norm.weight", (d,), "const", 1.0),
            ("layer_norm.bias", (d,), "const", 0.0)]
