"""Episodic engine for the extension heads: MMN eval, serve and training.

Counterpart of ``few_shot_seg_cwt_tpu.episodic.heads.HeadEngine`` for
``head_type "mmn"`` (reference: src/train_kshot.py:128-190):

  frozen backbone features with block-level taps (one pass over the batch)
  -> inner-loop adaptation of the episodic classifier (CUDA kernel K1)
  -> MMN refinement of the query feature (consensus on the pivot kernels
     on the flat route, cuDNN plane convs on the rank-4 route)
  -> classifier predictions upsampled to the image size
  -> the head's query loss (``seg_loss``) on the head's parameters only.

The prologue (backbone + inner loop) is batched over the E episodes, as the
JAX package's ``eval_split_prologue`` does; the head runs one episode at a
time, as its ``lax.map`` does, and training accumulates per-episode
gradients (``head_grad_accum``). Classifier inits come from a
``torch.Generator`` or are injected (``w0=``, (E, K, C)). Episodes are the
NHWC dicts of ``episodic.engine``. Not ported: the other heads (ROADMAP
queue 1 items 7-10), shot > 1 (item 2), ``use_amp`` (item 3) and the
``meta_aug`` support stream (item 7).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.mmn import build_mmn
from ..models.pspnet import apply_classifier, build_pspnet
from ..ops.losses import cross_entropy, seg_loss
from ..ops.metrics import intersection_and_union
from ..ops.resize import upsample_bilinear_ac
from .engine import EPISODE_KEYS, episodes_to_device, init_weights, pick_w0
from .inner_loop import adapt_classifier_batch

HEAD_TYPES = ("mmn", "detr", "match", "chm", "att", "asy", "fuse")
# ROADMAP queue 1 item of each head that is not ported yet
_UNPORTED = {"match": 7, "chm": 8, "detr": 9, "att": 10, "asy": 10, "fuse": 10}


def build_head(cfg, head_type: str):
    if head_type == "mmn":
        return build_mmn(cfg)
    if head_type in _UNPORTED:
        raise NotImplementedError(f"head {head_type!r} is not ported (ROADMAP "
                                  f"queue 1 item {_UNPORTED[head_type]})")
    raise ValueError(f"unknown head {head_type}")


class HeadEngine:
    """Eval, serve and train-step programs of one head, on one device."""

    def __init__(self, cfg, head_type: str = "mmn", backbone=None, head=None,
                 device="cuda"):
        if head_type not in HEAD_TYPES:
            raise ValueError(f"unknown head {head_type}")
        if cfg.get("meta_aug", 0) > 1 and cfg.get("att_type", 2) in (0, 1, 3):
            raise NotImplementedError("the meta_aug support stream is not ported "
                                      "(ROADMAP queue 1 item 7)")
        self.cfg = cfg
        self.head_type = head_type
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("HeadEngine: no CUDA device; pass device='cpu'")
        self.backbone = (backbone if backbone is not None
                         else build_pspnet(cfg)).to(self.device).eval()
        self.backbone.requires_grad_(False)
        self.head = (head if head is not None
                     else build_head(cfg, head_type)).to(self.device)
        self.num_classes = cfg.num_classes_tr
        self.image_size = cfg.image_size

    # ------------------------------------------------------------------ #
    # inputs and the shared prologue
    # ------------------------------------------------------------------ #

    def to_device(self, episodes: Dict) -> Dict[str, torch.Tensor]:
        return episodes_to_device(episodes, self.device)

    def init_weights(self, e: int, generator: torch.Generator) -> torch.Tensor:
        return init_weights(e, generator, self.num_classes, self.cfg.bottleneck_dim,
                            self.device)

    @torch.no_grad()
    def episode_parts(self, batch: Dict[str, torch.Tensor], w0: torch.Tensor) -> Dict:
        """Backbone features and the adapted classifier for E episodes.

        One backbone pass over the E*(shot+1) images, the inner loop for all
        E at once. Returns f_s (E, shot, h, w, C), f_q (E, h, w, C),
        fs_feats / fq_feats {stage: [(E, shot, ...) / (E, ...) NHWC]} for the
        head's stages, w (E, K, C), pd_q0 (E, h, w, K), s_valid (E, shot).
        """
        s_img, q_img = batch["s_img"], batch["q_img"]
        e, shot = s_img.shape[:2]
        n_s = e * shot
        imgs = torch.cat([s_img.reshape((n_s,) + s_img.shape[2:]), q_img], dim=0)
        feat, feats = self.backbone.extract_features(imgs)
        feat = feat.float()
        f_s = feat[:n_s].reshape((e, shot) + feat.shape[1:])
        f_q = feat[n_s:]
        stages = self.head.bids
        fs_feats = {k: [t[:n_s].reshape((e, shot) + t.shape[1:]) for t in feats[k]]
                    for k in stages}
        fq_feats = {k: [t[n_s:] for t in feats[k]] for k in stages}
        w = adapt_classifier_batch(f_s, batch["s_label"], w0, self.cfg.adapt_iter,
                                   self.cfg.cls_lr)
        # shots padded with all-255 labels take no part in the readout mean
        s_valid = (batch["s_label"] != 255).flatten(2).any(dim=-1).float()
        return dict(f_s=f_s, f_q=f_q, fs_feats=fs_feats, fq_feats=fq_feats, w=w,
                    pd_q0=apply_classifier(w, f_q), s_valid=s_valid)

    @staticmethod
    def _one(parts: Dict, batch: Dict, i: int) -> Tuple[Dict, Dict]:
        """Episode i of batched parts and inputs, in the JAX per-episode
        shapes (query tensors keep a leading axis of 1)."""
        part = dict(f_s=parts["f_s"][i], f_q=parts["f_q"][i:i + 1],
                    fs_feats={k: [t[i] for t in v] for k, v in parts["fs_feats"].items()},
                    fq_feats={k: [t[i:i + 1] for t in v] for k, v in parts["fq_feats"].items()},
                    w=parts["w"][i], pd_q0=parts["pd_q0"][i:i + 1],
                    s_valid=parts["s_valid"][i])
        return part, {k: v[i] for k, v in batch.items()}

    def _up(self, logits: torch.Tensor) -> torch.Tensor:
        return upsample_bilinear_ac(logits.float(), (self.image_size, self.image_size))

    def _cls_up(self, w: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        return self._up(apply_classifier(w, feat))

    # ------------------------------------------------------------------ #
    # the MMN head
    # ------------------------------------------------------------------ #

    def _mmn_att_shots(self, fq_feats, fs_feats, f_q, f_s, det: bool) -> torch.Tensor:
        """Per-shot MMN attention readouts, (shot, h, w, C); shot 1 only."""
        if f_s.shape[0] != 1:
            raise NotImplementedError("MMN with shot > 1 is not ported (ROADMAP "
                                      "queue 1 item 2)")
        return self.head(fq_feats, fs_feats, f_q, f_s, ret_shots=True,
                         deterministic=det)[2]

    def _loss_mmn(self, parts: Dict, episode: Dict, det: bool = False):
        """One episode: (loss, {"pred1", "pred"}) with (H, W, K) predictions."""
        cfg = self.cfg
        crit = lambda lg: seg_loss(lg, episode["q_label"],  # noqa: E731
                                   loss_type=cfg.get("loss_type", "wt_ce"))
        att_shots = self._mmn_att_shots(parts["fq_feats"], parts["fs_feats"],
                                        parts["f_q"], parts["f_s"], det)
        valid = parts["s_valid"]
        att_fq = (torch.sum(att_shots * valid[:, None, None, None], dim=0, keepdim=True)
                  / torch.clamp(valid.sum(), min=1.0))
        fq_blend = parts["f_q"] * (1 - cfg.att_wt) + att_fq * cfg.att_wt
        pred1 = self._cls_up(parts["w"], att_fq)[0]
        pred = self._cls_up(parts["w"], fq_blend)[0]
        if cfg.get("loss_shot", "avg") == "sum":
            per_shot = self._cls_up(parts["w"], att_shots)
            loss = sum(valid[k] * crit(per_shot[k]) for k in range(per_shot.shape[0]))
        else:
            loss = crit(pred1)
        aux = cfg.get("aux", False)
        if aux:
            loss = loss + aux * crit(pred)
        return loss, {"pred1": pred1, "pred": pred}

    def _iou(self, preds: Dict[str, torch.Tensor], parts: Dict, episode: Dict) -> Dict:
        out = {}
        for name, p in (("0", self._up(parts["pd_q0"])[0]), ("1", preds["pred1"]),
                        ("", preds["pred"])):
            inter, union, _ = intersection_and_union(p.argmax(-1), episode["q_label"],
                                                     self.num_classes)
            out[f"inter{name}"], out[f"union{name}"] = inter, union
        return out

    # ------------------------------------------------------------------ #
    # training
    # ------------------------------------------------------------------ #

    def train_episode_loss(self, parts: Dict, episode: Dict,
                           deterministic: bool = False):
        """One episode's loss (differentiable in the head's parameters) and
        its metrics: loss and I/U of pred0 (raw classifier), pred1 and pred."""
        loss, preds = self._loss_mmn(parts, episode, det=deterministic)
        metrics = {"loss": loss.detach()}
        with torch.no_grad():
            metrics.update(self._iou(preds, parts, episode))
        return loss, metrics

    def backward_batch(self, episodes, generator: Optional[torch.Generator] = None,
                       w0: Optional[torch.Tensor] = None,
                       deterministic: bool = False) -> Dict[str, torch.Tensor]:
        """The head's gradients of the mean episode loss, left in ``.grad``.

        With ``head_grad_accum`` (default) each episode's backward runs before
        the next episode's forward, so memory is one episode's; otherwise one
        backward over the summed losses. Returns the stacked metrics and
        ``loss_mean``.
        """
        batch = self.to_device(episodes)
        e = batch["q_img"].shape[0]
        parts = self.episode_parts(batch, pick_w0(self, e, generator, w0))
        self.head.zero_grad(set_to_none=True)
        accum = self.cfg.get("head_grad_accum", True)
        losses, metrics, total = [], [], 0.0
        for i in range(e):
            loss, m = self.train_episode_loss(*self._one(parts, batch, i), deterministic)
            if accum:
                (loss / e).backward()
            else:
                total = total + loss
            losses.append(loss.detach())
            metrics.append(m)
        if not accum:
            (total / e).backward()
        out = {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}
        out["loss_mean"] = torch.stack(losses).mean()
        return out

    def make_train_step(self, optimizer: torch.optim.Optimizer, scheduler=None):
        """step(episodes, generator=None, w0=None) -> metrics: one optimizer
        step on the mean episode loss (``scheduler`` steps per iteration)."""

        def step(episodes, generator=None, w0=None):
            metrics = self.backward_batch(episodes, generator, w0)
            optimizer.step()
            if scheduler is not None:
                scheduler.step()
            return metrics

        return step

    # ------------------------------------------------------------------ #
    # evaluation and serving
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def _predict_batch(self, batch: Dict, w0: torch.Tensor):
        parts = self.episode_parts(batch, w0)
        for i in range(batch["q_img"].shape[0]):
            part, episode = self._one(parts, batch, i)
            yield part, episode, self._loss_mmn(part, episode, det=True)[1]

    @torch.no_grad()
    def eval_metrics_batch(self, episodes, generator: Optional[torch.Generator] = None,
                           w0: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Deterministic head forward for E episodes: per-episode CE of pred
        and I/U of pred0, pred1 and pred, (E, ...) each, plus ``cls``."""
        batch = self.to_device(episodes)
        e = batch["q_img"].shape[0]
        outs = []
        for part, episode, preds in self._predict_batch(batch, pick_w0(self, e, generator, w0)):
            out = {"loss": cross_entropy(preds["pred"], episode["q_label"])}
            out.update(self._iou(preds, part, episode))
            outs.append(out)
        out = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        out["cls"] = batch["cls"]
        return out

    @torch.no_grad()
    def predict_batch(self, episodes, generator: Optional[torch.Generator] = None,
                      w0: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Label-free deterministic predictions for E episodes: ``pred1`` (the
        attention readout alone) and ``pred`` (blended into the query
        feature), (E, H, W, K) logits each. The query label is never read."""
        batch = self.to_device({k: v for k, v in episodes.items() if k != "q_label"})
        e = batch["q_img"].shape[0]
        # the head's loss runs on this placeholder and is dropped
        batch["q_label"] = torch.zeros(batch["q_img"].shape[:3], dtype=torch.long,
                                       device=self.device)
        preds = [p for _, _, p in self._predict_batch(batch, pick_w0(self, e, generator, w0))]
        return {k: torch.stack([p[k] for p in preds]) for k in ("pred1", "pred")}

    def serve_batch(self, episodes, generator: Optional[torch.Generator] = None,
                    w0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Label-free inference: E episodes -> (E, H, W) int32 masks, the
        argmax of the blended prediction."""
        return self.predict_batch(episodes, generator, w0)["pred"].argmax(-1).int()

    def serve_episode(self, episode, generator: Optional[torch.Generator] = None,
                      w0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One episode -> (H, W) int32 query mask."""
        one = {k: (v[None] if torch.is_tensor(v) else np.asarray(v)[None])
               for k, v in episode.items() if k in EPISODE_KEYS}
        if w0 is not None:
            w0 = torch.as_tensor(w0, dtype=torch.float32)[None]
        return self.serve_batch(one, generator, w0)[0]
