"""Episodic engine: evaluation, serving and meta-training of stage-2 CWT
episodes.

Counterpart of ``few_shot_seg_cwt_tpu.episodic.engine.EpisodicEngine``:

  backbone features (frozen, one pass over shot+1 images)
  -> inner-loop classifier adaptation (CUDA kernel for K=2 on the card)
  -> CWT weight update against the L2-normalised query features
  -> query prediction -> align-corners upsample -> I/U and CE, or a mask.

Episodes are dicts of NHWC arrays (numpy or torch)::

    {"s_img":  (E, shot, H, W, 3) float32,   # support images (normalised)
     "s_label":(E, shot, H, W)    int,       # {0,1,255}; padded shots all-255
     "q_img":  (E, H, W, 3)       float32,
     "q_label":(E, H, W)          int,
     "cls":    (E,)               int}       # episode class id (bookkeeping)

The ``*_batch`` methods take a leading episode axis E (written out as a
batch dimension where the JAX package used ``vmap``); the ``*_episode``
methods take one episode without it. The engine owns the backbone and the
transformer as ``nn.Module``s on its device, in eval mode. The meta-train
step (``make_train_step``) trains the transformer alone: the backbone is
frozen, and the transformer is in train mode (dropout live) only inside
the step's loss, so evaluation between steps runs without dropout.

Under a bf16 stage policy (``compute_dtype bfloat16``, ``use_amp`` or
``bf16_stages``; ``models.pspnet.stage_dtype_policy``) the backbone runs in
its stages' dtypes and the features come back to fp32: the inner loop, the
CWT, the classifier and the tail stay fp32, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.cwt import MultiHeadAttentionOne, build_cwt, dropout
from ..models.pspnet import (PSPNet, apply_classifier, build_pspnet, cast_backbone,
                             init_classifier_weights, stage_dtype_policy)
from ..ops.losses import (binary_weighted_ce_from_diff, class_balance_weights,
                          weighted_cross_entropy)
from ..ops.metrics import intersection_and_union
from ..ops.resize import upsample_bilinear_ac
from ..parallel.mesh import all_reduce_grads, rank_world
from .inner_loop import adapt_classifier_batch

EPISODE_KEYS = ("s_img", "s_label", "q_img", "q_label", "cls")


def l2_normalize_channels(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize(dim=channel) over the trailing channel axis."""
    norm = torch.sqrt(torch.sum(x.float() ** 2, dim=-1, keepdim=True))
    return (x / torch.clamp(norm, min=eps)).to(x.dtype)


def episodes_to_device(episodes: Dict, device) -> Dict[str, torch.Tensor]:
    """Episode fields as tensors on ``device`` (float32 images, int64 labels).
    The copy comes first and the cast after it, on ``device``: a pinned host
    tensor stays pinned for the copy, and int32 labels cross at half the
    bytes of int64."""
    out = {}
    for k in EPISODE_KEYS:
        if k not in episodes:
            continue
        v = episodes[k]
        v = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
        v = v.to(device, non_blocking=True)
        out[k] = v.float() if k.endswith("img") else v.long()
    return out


def init_weights(e: int, generator: torch.Generator, num_classes: int, dim: int,
                 device) -> torch.Tensor:
    """E fresh (K, C) classifier inits drawn from ``generator`` on the host."""
    return torch.stack([init_classifier_weights(generator, num_classes, dim)
                        for _ in range(e)]).to(device)


def pick_w0(engine, e: int, generator: Optional[torch.Generator],
            w0: Optional[torch.Tensor], shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Explicit (E, K, C) inits ``w0``, else E draws from ``generator``.

    ``shard`` (rank, world), in the train steps under a process group: the
    E episodes are rank's slice of a global batch of E * world, so the
    global batch's inits are drawn and rank's E kept. Every rank's generator
    starts alike and stays alike, and episode rank * E + i gets the init it
    gets on one process (the JAX step splits one key over the global
    batch)."""
    if w0 is not None:
        return torch.as_tensor(w0, dtype=torch.float32).to(engine.device)
    if generator is None:
        raise ValueError("pass a torch.Generator or explicit w0")
    rank, world = shard
    if world == 1:
        return engine.init_weights(e, generator)
    return engine.init_weights(e * world, generator)[rank * e:(rank + 1) * e]


class EpisodicEngine:
    """Eval and serve programs for one config, on one device."""

    def __init__(self, cfg, backbone: Optional[PSPNet] = None,
                 cwt: Optional[MultiHeadAttentionOne] = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("EpisodicEngine: no CUDA device; pass device='cpu'")
        # the stage policy casts a passed backbone in place, as build_pspnet
        # casts its own
        self.backbone = cast_backbone(backbone if backbone is not None
                                      else build_pspnet(cfg), stage_dtype_policy(cfg))
        self.backbone.to(self.device).eval()
        self.backbone.requires_grad_(False)
        self.cwt = (cwt if cwt is not None else build_cwt(cfg)).to(self.device).eval()
        self.num_classes = cfg.num_classes_tr
        self.adapt_iter = cfg.adapt_iter
        self.cls_lr = cfg.cls_lr
        self.bottleneck_dim = cfg.bottleneck_dim

    # ------------------------------------------------------------------ #
    # inputs
    # ------------------------------------------------------------------ #

    def to_device(self, episodes: Dict) -> Dict[str, torch.Tensor]:
        return episodes_to_device(episodes, self.device)

    def init_weights(self, e: int, generator: torch.Generator) -> torch.Tensor:
        """E fresh (K, C) classifier inits drawn from ``generator``."""
        return init_weights(e, generator, self.num_classes, self.bottleneck_dim,
                            self.device)

    # ------------------------------------------------------------------ #
    # building blocks (batched over E)
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def _episode_features(self, batch, support_dropout: bool = False,
                          generator: Optional[torch.Generator] = None,
                          shard: Tuple[int, int] = (0, 1)
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Backbone features: ONE pass over the E*(shot+1) images.

        Returns f_s (E, shot, h, w, C) and f_q (E, h, w, C), fp32 whatever
        the stage policy (the backbone casts the images to its stem's dtype).

        ``support_dropout`` (the train step): the reference extracts support
        features in train mode, where the bottleneck's channel dropout is
        the only difference; the same mask is applied here to f_s alone,
        Bernoulli(1 - ``cfg.dropout``) per (episode, shot, channel) from
        ``generator``, kept channels scaled by 1/(1 - rate), drawn for the
        global batch of which this one is rank ``shard[0]``'s slice.
        """
        s_img, q_img = batch["s_img"], batch["q_img"]
        e, shot = s_img.shape[:2]
        imgs = torch.cat([s_img.reshape((e * shot,) + s_img.shape[2:]), q_img], dim=0)
        feat = self.backbone.extract_features(imgs).float()
        f_s = feat[: e * shot].reshape((e, shot) + feat.shape[1:])
        if support_dropout:
            mask_shape = (e, shot, 1, 1, f_s.shape[-1])
            f_s = dropout(f_s, float(self.cfg.dropout), generator, mask_shape, shard)
        return f_s, feat[e * shot:]

    @torch.no_grad()
    def _adapted_episode(self, batch, w0: torch.Tensor):
        """Shared eval prologue: features + inner-loop-adapted classifier."""
        f_s, f_q = self._episode_features(batch)
        w = adapt_classifier_batch(f_s, batch["s_label"], w0, self.adapt_iter,
                                   self.cls_lr)
        return f_q, w

    @torch.no_grad()
    def _predict(self, f_q: torch.Tensor, w: torch.Tensor):
        """Raw-classifier and CWT-updated query logits, (E, h, w, K) each."""
        pred_q0 = apply_classifier(w, f_q)
        f_qn = l2_normalize_channels(f_q)
        w_upd = self.cwt(w, f_qn, f_qn)
        pred_q = apply_classifier(w_upd, f_qn)
        return pred_q, pred_q0

    def _upsampled_diff(self, pred: torch.Tensor, size) -> torch.Tensor:
        """(E, h, w, 2) feature-res logits -> upsampled (E, H, W) difference."""
        d = (pred[..., 1] - pred[..., 0]).float()
        return upsample_bilinear_ac(d[..., None], tuple(size))[..., 0]

    def _upsampled_metrics(self, pred: torch.Tensor, q_label: torch.Tensor):
        """align-corners upsample -> argmax I/U + unweighted CE, per episode.

        pred (E, h, w, K), q_label (E, H, W) -> inter (E, K), union (E, K),
        loss (E,).
        """
        size = q_label.shape[-2:]
        ones = torch.ones((self.num_classes,), dtype=torch.float32, device=pred.device)
        if self.num_classes == 2:
            # K=2: argmax and CE depend only on the logit difference, so the
            # whole tail runs on one (H, W) plane. Ties: argmax picks class 0
            # <=> d > 0 exactly.
            d = self._upsampled_diff(pred, size)
            inter, union, _ = intersection_and_union((d > 0).long(), q_label, 2)
            loss = torch.stack([binary_weighted_ce_from_diff(d[i], q_label[i], ones)
                                for i in range(d.shape[0])])
            return inter, union, loss
        logits = upsample_bilinear_ac(pred.float(), tuple(size))
        inter, union, _ = intersection_and_union(logits.argmax(-1), q_label,
                                                 self.num_classes)
        loss = torch.stack([weighted_cross_entropy(logits[i], q_label[i], ones)
                            for i in range(logits.shape[0])])
        return inter, union, loss

    def metrics_from_predictions(self, pred_q, pred_q0, batch) -> Dict[str, torch.Tensor]:
        q_label = batch["q_label"]
        inter, union, loss = self._upsampled_metrics(pred_q, q_label)
        inter0, union0, loss0 = self._upsampled_metrics(pred_q0, q_label)
        return {"inter": inter, "union": union, "inter0": inter0,
                "union0": union0, "loss": loss, "loss0": loss0,
                "cls": batch["cls"]}

    def mask_from_prediction(self, pred_q: torch.Tensor, size) -> torch.Tensor:
        """(E, h, w, K) logits -> (E, H, W) int32 mask at image resolution."""
        if self.num_classes == 2:
            return (self._upsampled_diff(pred_q, size) > 0).int()
        logits = upsample_bilinear_ac(pred_q.float(), tuple(size))
        return logits.argmax(-1).int()

    # ------------------------------------------------------------------ #
    # batched programs
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def eval_batch_from_w0(self, episodes, w0) -> Dict[str, torch.Tensor]:
        """Inner loop + CWT update + query logits for E episodes from given
        (E, K, C) classifier inits."""
        batch = self.to_device(episodes)
        w0 = torch.as_tensor(w0, dtype=torch.float32).to(self.device)
        f_q, w = self._adapted_episode(batch, w0)
        pred_q, pred_q0 = self._predict(f_q, w)
        return {"pred_q": pred_q, "pred_q0": pred_q0, "cls": batch["cls"]}

    def eval_batch(self, episodes, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        e = len(episodes["q_img"])
        return self.eval_batch_from_w0(episodes, self.init_weights(e, generator))

    @torch.no_grad()
    def eval_metrics_batch(self, episodes, generator: Optional[torch.Generator] = None,
                           w0: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Per-episode I/U (transformed and raw classifier) and CE losses;
        classifier inits from ``generator`` or explicit ``w0``."""
        return self._eval_metrics(episodes, generator, w0, with_pred=False)

    @torch.no_grad()
    def eval_metrics_batch_pred(self, episodes, generator: Optional[torch.Generator] = None,
                                w0: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """``eval_metrics_batch`` plus ``pred_lab``, the (E, h, w) int32 argmax
        of the transformed prediction at feature resolution: one program gives
        the metrics and the masks that the dtype A/B compares."""
        return self._eval_metrics(episodes, generator, w0, with_pred=True)

    def _eval_metrics(self, episodes, generator, w0, with_pred: bool):
        batch = self.to_device(episodes)
        e = batch["q_img"].shape[0]
        f_q, w = self._adapted_episode(batch, pick_w0(self, e, generator, w0))
        pred_q, pred_q0 = self._predict(f_q, w)
        out = self.metrics_from_predictions(pred_q, pred_q0, batch)
        if with_pred:
            out["pred_lab"] = pred_q.argmax(-1).int()
        return out

    @torch.no_grad()
    def eval_metrics_batch_no_cwt(self, episodes, generator: Optional[torch.Generator] = None,
                                  w0: Optional[torch.Tensor] = None
                                  ) -> Dict[str, torch.Tensor]:
        """Inner loop + the adapted classifier's own query metrics, no CWT:
        per-episode ``inter0``, ``union0``, ``loss0`` and ``cls``. Stage-1
        pretraining's episodic validation (reference src/test.py:257-371
        has no transformer)."""
        batch = self.to_device(episodes)
        e = batch["q_img"].shape[0]
        f_q, w = self._adapted_episode(batch, pick_w0(self, e, generator, w0))
        inter0, union0, loss0 = self._upsampled_metrics(apply_classifier(w, f_q),
                                                        batch["q_label"])
        return {"inter0": inter0, "union0": union0, "loss0": loss0, "cls": batch["cls"]}

    @torch.no_grad()
    def serve_batch(self, episodes, generator: Optional[torch.Generator] = None,
                    w0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Label-free inference: E episodes -> (E, H, W) int32 query masks."""
        batch = self.to_device(episodes)
        e = batch["q_img"].shape[0]
        f_q, w = self._adapted_episode(batch, pick_w0(self, e, generator, w0))
        pred_q, _ = self._predict(f_q, w)
        return self.mask_from_prediction(pred_q, batch["q_img"].shape[1:3])

    # ------------------------------------------------------------------ #
    # meta-training
    # ------------------------------------------------------------------ #

    def _train_losses(self, f_q: torch.Tensor, w: torch.Tensor, q_label: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      with_metrics: bool = True, shard: Tuple[int, int] = (0, 1)):
        """Per-episode query losses (E,), differentiable in the transformer's
        parameters, from the raw query features and the adapted classifier.

        The transformer runs in train mode (both dropouts live, masks from
        ``generator``) and is back in eval mode on return. The loss is the
        class-weighted CE of the upsampled prediction, weights [1, n_bg/n_fg]
        of each query label. ``with_metrics`` adds the I/U of the transformed
        and raw classifiers, as the JAX ``train_episode_loss`` does.
        """
        with torch.no_grad():
            f_qn = l2_normalize_channels(f_q)
        self.cwt.train()
        try:
            w_upd = self.cwt(w, f_qn, f_qn, generator=generator, shard=shard)
        finally:
            self.cwt.eval()
        logits60 = apply_classifier(w_upd, f_qn)          # (E, h, w, K)
        size = q_label.shape[-2:]
        e = q_label.shape[0]
        qw = [class_balance_weights(q_label[i], num_classes=self.num_classes)
              for i in range(e)]
        if self.num_classes == 2:
            # single-plane tail; its gradient is the two-logit CE gradient
            d = self._upsampled_diff(logits60, size)
            losses = torch.stack([binary_weighted_ce_from_diff(d[i], q_label[i], qw[i])
                                  for i in range(e)])
        else:
            logits = upsample_bilinear_ac(logits60.float(), tuple(size))
            losses = torch.stack([weighted_cross_entropy(logits[i], q_label[i], qw[i])
                                  for i in range(e)])
        if not with_metrics:
            return losses, {}
        with torch.no_grad():
            inter, union, _ = self._upsampled_metrics(logits60, q_label)
            inter0, union0, _ = self._upsampled_metrics(apply_classifier(w, f_q), q_label)
        return losses, {"inter": inter, "union": union, "inter0": inter0, "union0": union0}

    def train_episode_losses(self, episodes, generator: Optional[torch.Generator] = None,
                             w0: Optional[torch.Tensor] = None, with_metrics: bool = True):
        """The JAX ``train_episode_loss`` for E episodes: per-episode losses
        (E,), differentiable in the transformer's parameters, and metrics.

        Classifier inits come from ``w0`` (E, K, C) or are drawn from
        ``generator``, which then also draws the support-dropout and the
        transformer's dropout masks, in that order. With every dropout rate
        at 0 no generator is needed. Under a process group the E episodes
        are this rank's slice of the global batch, and every draw is the
        global batch's, of which this rank keeps its rows (``pick_w0``,
        ``models.cwt.dropout``).
        """
        batch = self.to_device(episodes)
        shard = rank_world()
        w0 = pick_w0(self, batch["q_img"].shape[0], generator, w0, shard)
        f_s, f_q = self._episode_features(batch, support_dropout=True, generator=generator,
                                          shard=shard)
        with torch.no_grad():   # no gradient flows into the inner loop
            w = adapt_classifier_batch(f_s, batch["s_label"], w0, self.adapt_iter,
                                       self.cls_lr)
        return self._train_losses(f_q, w, batch["q_label"], generator, with_metrics, shard)

    def make_train_step(self, optimizer: torch.optim.Optimizer, with_metrics: bool = True):
        """step(episodes, generator=None, w0=None) -> metrics: one optimizer
        step on the transformer over the mean episode loss. ``metrics`` holds
        ``loss`` and, with ``with_metrics``, the (E, K) I/U of the transformed
        and raw classifiers (the loss-only step skips that tail). Under a
        process group the episodes are this rank's slice, and the gradients
        are averaged over the ranks before the optimizer step
        (``parallel.mesh.all_reduce_grads``); ``metrics`` stay this rank's."""

        def step(episodes, generator=None, w0=None):
            self.cwt.zero_grad(set_to_none=True)
            losses, metrics = self.train_episode_losses(episodes, generator, w0,
                                                        with_metrics)
            loss = losses.mean()
            loss.backward()
            all_reduce_grads(self.cwt.parameters())
            optimizer.step()
            metrics["loss"] = loss.detach()
            return metrics

        return step

    # ------------------------------------------------------------------ #
    # single-episode programs (a batch of one)
    # ------------------------------------------------------------------ #

    @staticmethod
    def _one(episode) -> Dict:
        return {k: (v[None] if torch.is_tensor(v) else np.asarray(v)[None])
                for k, v in episode.items() if k in EPISODE_KEYS}

    @staticmethod
    def _first(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: v[0] for k, v in out.items()}

    def eval_episode_from_w0(self, episode, w0) -> Dict[str, torch.Tensor]:
        """One episode from an injected (K, C) init: pred_q, pred_q0 (h, w, K)."""
        w0 = torch.as_tensor(w0, dtype=torch.float32)[None]
        return self._first(self.eval_batch_from_w0(self._one(episode), w0))

    def eval_episode(self, episode, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        return self._first(self.eval_batch(self._one(episode), generator))

    def eval_episode_metrics(self, episode, generator: Optional[torch.Generator] = None,
                             w0: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        if w0 is not None:
            w0 = torch.as_tensor(w0, dtype=torch.float32)[None]
        return self._first(self.eval_metrics_batch(self._one(episode), generator, w0))

    def serve_episode(self, episode, generator: Optional[torch.Generator] = None,
                      w0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One episode -> (H, W) int32 query mask."""
        if w0 is not None:
            w0 = torch.as_tensor(w0, dtype=torch.float32)[None]
        return self.serve_batch(self._one(episode), generator, w0)[0]
