"""Episodic engine for the extension heads: MMN and the match head.

Counterpart of ``few_shot_seg_cwt_tpu.episodic.heads.HeadEngine`` for
``head_type "mmn"`` (reference: src/train_kshot.py:128-190) and ``"match"``
(MatchNet, src/train_match.py:123-190 and :318-322):

  frozen backbone features with block-level taps (one pass over the batch)
  -> inner-loop adaptation of the episodic classifier (CUDA kernel K1)
  -> the head's refinement of the query feature (consensus on the pivot
     kernels on the flat route, cuDNN plane convs on the rank-4 route,
     6D plane convs or the true 4D conv on the 6D route)
  -> classifier predictions upsampled to the image size
  -> the head's query loss on the head's parameters only.

The prologue (backbone + inner loop) is batched over the E episodes, as the
JAX package's ``eval_split_prologue`` does; the head runs one episode at a
time, as its ``lax.map`` does, or ``eval_episode_tile`` episodes in one
batched call in eval and serve when the tile divides the batch (its
``lax.map(batch_size=tile)``); training accumulates per-episode gradients
(``head_grad_accum``). MMN: at shot > 1 the head runs per shot
(``_mmn_att_shots``) and the readouts are averaged over the valid shots;
shots padded with all-255 labels take no part; with ``meta_aug > 1`` and
``att_type`` 0, 1 or 3 the head reads one view of each [original,
augmented] support pair (``_select_support_stream``). Match: 1-shot only;
the cycle-consistency mask and the ``ignore`` re-readout run at eval only,
as in the reference. Under ``use_amp`` (or another bf16 stage policy) the
backbone runs bf16 and its features come back to fp32; the train step
under ``use_amp`` also runs the head in bf16 (``_amp_head``), while eval
and serve keep the head in fp32, as the JAX package does. Classifier inits
come from a ``torch.Generator`` or are injected (``w0=``, (E, K, C)).
Episodes are the NHWC dicts of ``episodic.engine``. Not ported: the other
heads (ROADMAP queue 1 items 8-10).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..models.conv4d import init_conv_parameters
from ..models.matching import MatchNet, block_remat_default
from ..models.mmn import FEATURE_CHANNELS, build_mmn
from ..models.pspnet import apply_classifier, build_pspnet, cast_backbone, stage_dtype_policy
from ..models.vgg import VGG16_STAGES
from ..ops.episode_utils import att_weighted_out, get_ig_mask
from ..ops.losses import class_balance_weights, cross_entropy, seg_loss, weighted_cross_entropy
from ..ops.metrics import intersection_and_union
from ..ops.resize import upsample_bilinear_ac
from ..parallel.mesh import all_reduce_grads, rank_world
from .engine import EPISODE_KEYS, episodes_to_device, init_weights, pick_w0
from .inner_loop import adapt_classifier_batch

HEAD_TYPES = ("mmn", "detr", "match", "chm", "att", "asy", "fuse")
# ROADMAP queue 1 item of each head that is not ported yet
_UNPORTED = {"chm": 8, "detr": 9, "att": 10, "asy": 10, "fuse": 10}


def match_stage(cfg):
    """The backbone tap the match head reads (JAX ``_stage_features``):
    ``feats["nr"]`` for ``rmid nr``, else stage int(rmid[-1]) (4 without
    an rmid)."""
    rmid = cfg.get("rmid") or None
    if rmid == "nr":
        return "nr"
    return 4 if rmid is None else int(str(rmid)[-1])


def stage_channels(cfg, stage) -> int:
    """Channels of a backbone tap: the ResNet's block outputs or VGG's
    stage outputs (``nr`` is ResNet layer4's)."""
    stage = 4 if stage == "nr" else int(stage)
    if cfg.get("arch", "resnet") == "vgg":
        return VGG16_STAGES[stage][1]
    return FEATURE_CHANNELS[stage - 1]


def build_match(cfg, generator: Optional[torch.Generator] = None) -> MatchNet:
    """MatchNet with the JAX ``build_head("match")`` arguments (one
    correlation channel, symmetric consensus) and a seeded init
    (U(+-1/sqrt(fan_in)) kernels; zero Conv2d biases, U(+-1/sqrt(fan_in))
    true-4D biases, as the JAX package initialises them)."""
    cv = cfg.get("conv4d", "red")
    model = MatchNet(temp=cfg.temp, cv_type=cv, sce=bool(cfg.get("sce", False)),
                     cyc=bool(cfg.get("cyc", False)), sym_mode=True, in_channel=1,
                     block_remat=block_remat_default(cfg, cv),
                     feat_dim=stage_channels(cfg, match_stage(cfg)))
    if generator is None:
        generator = torch.Generator().manual_seed(int(cfg.get("manual_seed") or 0) + 1)
    init_conv_parameters(model, generator)
    return model


def build_head(cfg, head_type: str):
    if head_type == "mmn":
        return build_mmn(cfg)
    if head_type == "match":
        return build_match(cfg)
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
        if head_type in ("detr", "match", "chm") and int(cfg.shot) > 1:
            # the reference's get_corr views k with q's batch, so these heads
            # only ever run the 1-shot protocol
            raise ValueError(f"head '{head_type}' supports shot=1 only (got "
                             f"shot={cfg.shot}); use the mmn head for k-shot episodes")
        self.cfg = cfg
        self.head_type = head_type
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("HeadEngine: no CUDA device; pass device='cpu'")
        # use_amp / compute_dtype / bf16_stages: the backbone's stage policy,
        # cast in place on a passed backbone as build_pspnet casts its own
        self.backbone = cast_backbone(backbone if backbone is not None
                                      else build_pspnet(cfg), stage_dtype_policy(cfg))
        self.backbone.to(self.device).eval()
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

    def _stages(self):
        """The backbone taps the head reads."""
        if self.head_type == "match":
            return [match_stage(self.cfg)]
        return list(self.head.bids)

    @torch.no_grad()
    def episode_parts(self, batch: Dict[str, torch.Tensor], w0: torch.Tensor) -> Dict:
        """Backbone features and the adapted classifier for E episodes.

        One backbone pass over the E*(shot+1) images, the inner loop for all
        E at once. Returns f_s (E, shot, h, w, C), f_q (E, h, w, C),
        fs_feats / fq_feats {stage: [(E, shot, ...) / (E, ...) NHWC]} for the
        head's stages, w (E, K, C), pd_q0 (E, h, w, K), pd_s (E, shot, h, w,
        K), s_valid (E, shot); fp32 whatever the backbone's stage policy.
        """
        s_img, q_img = batch["s_img"], batch["q_img"]
        e, shot = s_img.shape[:2]
        n_s = e * shot
        imgs = torch.cat([s_img.reshape((n_s,) + s_img.shape[2:]), q_img], dim=0)
        feat, feats = self.backbone.extract_features(imgs)
        feat = feat.float()
        f_s = feat[:n_s].reshape((e, shot) + feat.shape[1:])
        f_q = feat[n_s:]
        feats = {k: [t.float() for t in feats[k]] for k in self._stages()}
        fs_feats = {k: [t[:n_s].reshape((e, shot) + t.shape[1:]) for t in v]
                    for k, v in feats.items()}
        fq_feats = {k: [t[n_s:] for t in v] for k, v in feats.items()}
        w = adapt_classifier_batch(f_s, batch["s_label"], w0, self.cfg.adapt_iter,
                                   self.cfg.cls_lr)
        pd_s = apply_classifier(w.repeat_interleave(shot, dim=0), f_s.flatten(0, 1))
        # shots padded with all-255 labels take no part in the readout mean
        s_valid = (batch["s_label"] != 255).flatten(2).any(dim=-1).float()
        return dict(f_s=f_s, f_q=f_q, fs_feats=fs_feats, fq_feats=fq_feats, w=w,
                    pd_q0=apply_classifier(w, f_q),
                    pd_s=pd_s.reshape((e, shot) + pd_s.shape[1:]), s_valid=s_valid)

    @staticmethod
    def _one(parts: Dict, batch: Dict, i: int) -> Tuple[Dict, Dict]:
        """Episode i of batched parts and inputs, in the JAX per-episode
        shapes (query tensors keep a leading axis of 1)."""
        part = dict(f_s=parts["f_s"][i], f_q=parts["f_q"][i:i + 1],
                    fs_feats={k: [t[i] for t in v] for k, v in parts["fs_feats"].items()},
                    fq_feats={k: [t[i:i + 1] for t in v] for k, v in parts["fq_feats"].items()},
                    w=parts["w"][i], pd_q0=parts["pd_q0"][i:i + 1], pd_s=parts["pd_s"][i],
                    s_valid=parts["s_valid"][i])
        return part, {k: v[i] for k, v in batch.items()}

    def _up(self, logits: torch.Tensor) -> torch.Tensor:
        # fp32 here is the AMP boundary: upsample, losses and metrics in fp32
        return upsample_bilinear_ac(logits.float(), (self.image_size, self.image_size))

    def _cls_up(self, w: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        return self._up(apply_classifier(w, feat))

    # ------------------------------------------------------------------ #
    # the MMN head
    # ------------------------------------------------------------------ #

    def _mmn_att_shots(self, fq_feats, fs_feats, f_q, f_s, det: bool) -> torch.Tensor:
        """Per-shot MMN attention readouts, (shot, h, w, C).

        shot 1: one head apply. shot > 1, the JAX package's settings:
        ``shot_hoist_query`` (default on) runs the query-side prep once
        outside the per-shot map, one dropout draw shared by the shots in
        training (the reference redraws it per shot); ``shot_native`` sends
        every shot through one head apply; otherwise the map takes
        ``shot_tile`` shots a chunk where the tile divides the shot count,
        else one shot at a time, each chunk under ``torch.utils.checkpoint``
        while ``shot_remat`` (default on), so the live activations are one
        chunk's consensus stack. Dropout draws from torch's default
        generator on the device, chunk after chunk in shot order (the
        checkpoint replays a chunk's draws in its recompute), so a saved
        generator state resumes exactly.
        """
        def apply(fs_k, f_s_k, fq_prepped=None):
            return self.head(fq_feats, fs_k, f_q, f_s_k, ret_shots=True,
                             deterministic=det, fq_prepped=fq_prepped)[2]

        shot = f_s.shape[0]
        if shot == 1:
            return apply(fs_feats, f_s)
        cfg = self.cfg
        fq_prepped = (self.head.prep_query(fq_feats, deterministic=det)
                      if cfg.get("shot_hoist_query", True) else None)
        if cfg.get("shot_native", False):
            return apply(fs_feats, f_s, fq_prepped)
        tile = int(cfg.get("shot_tile", 1) or 1)
        tile = tile if tile > 1 and shot % tile == 0 else 1
        remat = cfg.get("shot_remat", True) and torch.is_grad_enabled()
        outs = []
        for k in range(0, shot, tile):
            fs_k = {st: [t[k:k + tile] for t in v] for st, v in fs_feats.items()}
            if remat:
                outs.append(checkpoint(apply, fs_k, f_s[k:k + tile], fq_prepped,
                                       use_reentrant=False))
            else:
                outs.append(apply(fs_k, f_s[k:k + tile], fq_prepped))
        return torch.cat(outs, dim=0)

    def _select_support_stream(self, parts: Dict, episode: Dict) -> Dict:
        """``meta_aug > 1``: the support views the head reads. The support
        axis interleaves [org_0, aug_0, org_1, aug_1, ...] (the data layer's
        ``_support_with_aug``); ``att_type`` 0 keeps the originals, 1 the
        augmented views, 3 picks per pair the view the adapted classifier
        segments better (mean FG/BG IoU of pd_s against s_label,
        src/train_aug.py:148-158). Other settings read every view."""
        cfg = self.cfg
        att_type = cfg.get("att_type", 2)
        if cfg.get("meta_aug", 0) <= 1 or att_type not in (0, 1, 3):
            return parts
        n = parts["f_s"].shape[0]
        pairs = n // 2
        base = torch.arange(pairs, device=parts["f_s"].device) * 2
        if att_type in (0, 1):
            sel = base + att_type
        else:
            logits = upsample_bilinear_ac(parts["pd_s"].float(), episode["s_label"].shape[-2:])
            inter, union, _ = intersection_and_union(logits.argmax(-1), episode["s_label"],
                                                     self.num_classes)
            iou = (inter / (union + 1e-10)).mean(dim=-1).reshape(pairs, 2)
            sel = base + iou.argmax(dim=-1)
        out = dict(parts)
        out["f_s"] = parts["f_s"][sel]
        out["fs_feats"] = {k: [t[sel] for t in v] for k, v in parts["fs_feats"].items()}
        out["pd_s"] = parts["pd_s"][sel]
        out["s_valid"] = parts["s_valid"][sel]
        return out

    def _loss_mmn(self, parts: Dict, episode: Dict, det: bool = False,
                  att_shots: Optional[torch.Tensor] = None):
        """One episode: (loss, {"pred1", "pred"}) with (H, W, K) predictions;
        ``att_shots`` are the head's per-shot readouts where a batched call
        (``_head_chunk``) already computed them."""
        cfg = self.cfg
        parts = self._select_support_stream(parts, episode)
        crit = lambda lg: seg_loss(lg, episode["q_label"],  # noqa: E731
                                   loss_type=cfg.get("loss_type", "wt_ce"))
        if att_shots is None:
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

    # ------------------------------------------------------------------ #
    # the match head
    # ------------------------------------------------------------------ #

    def _match_apply(self, parts: Dict, det: bool):
        """MatchNet on the stage features of a batch of 1-shot episodes
        (leading axis B): (readout (B, h, w, C), filtered correlation
        (B, h, w, h, w)). The cycle mask is on at eval only
        (src/train_match.py:163 trains with use_cyc=False)."""
        key = match_stage(self.cfg)
        fq_fea, fs_fea = parts["fq_feats"][key][-1], parts["fs_feats"][key][-1]
        return self.head(fq_fea, fs_fea, parts["f_s"],
                         s_mask=torch.argmax(parts["pd_s"], dim=-1), use_cyc=det,
                         deterministic=det, ret_corr=True)

    def _loss_match(self, parts: Dict, episode: Dict, det: bool = False,
                    head_out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    train: bool = False):
        """One episode: class-balanced CE on pred1 (+ the disagreement loss
        under ``aux``). At eval (``det`` and not ``train``) the cycle mask is
        on, and with ``ignore`` the readout is redone over the query feature
        with the support ignore mask (src/train_match.py:318-322, replicated
        as the JAX package does); the train step runs neither, whatever
        ``det``, as the JAX train step does."""
        cfg = self.cfg
        at_eval = det and not train
        qw = class_balance_weights(episode["q_label"], self.num_classes)
        wv, corr1 = head_out if head_out is not None else self._match_apply(parts, at_eval)
        if at_eval and cfg.get("ignore", False):
            _, h, w, _ = parts["f_q"].shape
            sim = corr1.reshape(1, h * w, h * w)
            ig_mask = get_ig_mask(sim, episode["s_label"][:1], episode["q_label"][None],
                                  parts["pd_q0"], parts["pd_s"][:1])
            wv = att_weighted_out(sim, parts["f_q"], temp=cfg.temp, ig_mask=ig_mask)
        pred1 = self._cls_up(parts["w"], wv)[0]
        out = (wv * cfg.att_wt + parts["f_q"]) / (1 + cfg.att_wt)
        pred = self._cls_up(parts["w"], out)[0]
        loss = weighted_cross_entropy(pred1, episode["q_label"], qw)
        if cfg.get("aux", False):
            loss = loss + disagreement_loss(pred, self._up(parts["pd_q0"])[0], pred1,
                                            episode["q_label"])
        return loss, {"pred1": pred1, "pred": pred}

    def _loss(self, parts: Dict, episode: Dict, det: bool = False, head_out=None,
              train: bool = False):
        if self.head_type == "match":
            return self._loss_match(parts, episode, det, head_out, train)
        return self._loss_mmn(parts, episode, det, head_out)

    def _head_chunk(self, pieces) -> list:
        """The head's output for several episodes in one batched
        deterministic call: ``pieces`` are (part, episode) pairs of
        ``_one``; returns each episode's ``head_out`` for ``_loss``."""
        if self.head_type == "match":
            cat = _cat_parts([p for p, _ in pieces])
            wv, corr = self._match_apply(cat, True)
            return [(wv[i:i + 1], corr[i:i + 1]) for i in range(len(pieces))]
        sel = [self._select_support_stream(p, ep) for p, ep in pieces]
        shot = sel[0]["f_s"].shape[0]
        cat = _cat_parts(sel)
        fq_prepped = [t.repeat_interleave(shot, dim=0)
                      for t in self.head.prep_query(cat["fq_feats"], deterministic=True)]
        att = self.head(cat["fq_feats"], cat["fs_feats"], cat["f_q"], cat["f_s"],
                        ret_shots=True, deterministic=True, fq_prepped=fq_prepped)[2]
        return list(att.split(shot, dim=0))

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

    @contextlib.contextmanager
    def _amp_head(self):
        """``use_amp`` in the train step: for the enclosed forward AND
        backward every floating parameter of the head is a bf16 cast of its
        fp32 master, so the head computes in bf16 and the gradients flow
        back through the casts to the masters (the per-shot and per-block
        checkpoints recompute inside the backward, so they see the same
        casts). bf16 has fp32's exponent range: no loss scaling."""
        if not self.cfg.get("use_amp", False):
            yield
            return
        masters = [(m, name, p) for m in self.head.modules()
                   for name, p in m._parameters.items()
                   if p is not None and p.is_floating_point()]
        try:
            for m, name, p in masters:
                m._parameters[name] = p.to(torch.bfloat16)
            yield
        finally:
            for m, name, p in masters:
                m._parameters[name] = p

    def train_episode_loss(self, parts: Dict, episode: Dict,
                           deterministic: bool = False):
        """One episode's loss (differentiable in the head's parameters) and
        its metrics: loss and I/U of pred0 (raw classifier), pred1 and pred.

        Under ``use_amp`` the parts go to bf16 at the loss boundary (call it
        inside ``_amp_head``); predictions are upsampled in fp32 (``_up``),
        so the loss and the metrics keep full precision."""
        loss_parts = parts
        if self.cfg.get("use_amp", False):
            loss_parts = _cast_floats(parts, torch.bfloat16)
        loss, preds = self._loss(loss_parts, episode, det=deterministic, train=True)
        loss = loss.float()
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
        ``loss_mean``. Under a process group the episodes are this rank's
        slice of the global batch and the inits drawn from ``generator`` are
        the global batch's, of which this rank keeps its rows
        (``engine.pick_w0``). The head's own dropout draws from torch's
        default generator on the device, episode after episode inside the
        forward and backward passes, so no global draw can be sliced there:
        each rank draws its own (``train.common.set_seeds`` seeds it with
        ``manual_seed + rank``).
        """
        batch = self.to_device(episodes)
        e = batch["q_img"].shape[0]
        parts = self.episode_parts(batch, pick_w0(self, e, generator, w0, rank_world()))
        self.head.zero_grad(set_to_none=True)
        accum = self.cfg.get("head_grad_accum", True)
        losses, metrics, total = [], [], 0.0
        # one bf16 cast of the head for the batch: the casts save no
        # tensors, so each episode's backward may pass through them
        with self._amp_head():
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
        step on the mean episode loss (``scheduler`` steps per iteration).
        Under a process group the gradients are averaged over the ranks
        before the step (``parallel.mesh.all_reduce_grads``)."""

        def step(episodes, generator=None, w0=None):
            metrics = self.backward_batch(episodes, generator, w0)
            all_reduce_grads(self.head.parameters())
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
        """(part, episode, preds) per episode, deterministic. With
        ``eval_episode_tile`` > 1 dividing the batch the head runs on chunks
        of that many episodes in one batched call, else one episode at a
        time (the JAX ``lax.map(batch_size=tile)``)."""
        parts = self.episode_parts(batch, w0)
        e = batch["q_img"].shape[0]
        tile = int(self.cfg.get("eval_episode_tile", 1) or 1)
        tile = tile if tile > 1 and e % tile == 0 else 1
        for i0 in range(0, e, tile):
            pieces = [self._one(parts, batch, i) for i in range(i0, i0 + tile)]
            outs = self._head_chunk(pieces) if tile > 1 else [None]
            for (part, episode), out in zip(pieces, outs):
                yield part, episode, self._loss(part, episode, det=True, head_out=out)[1]

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
        if self.head_type == "match" and self.cfg.get("ignore", False):
            raise ValueError("match-head serving requires `ignore False`: the eval-time "
                             "ig-mask re-readout consumes the query label")
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


def disagreement_loss(pred: torch.Tensor, pred0: torch.Tensor, pred1: torch.Tensor,
                      q_label: torch.Tensor, ignore_index: int = 255) -> torch.Tensor:
    """CE of pred weighted 1 where pred0 and pred1 disagree and 0.001 elsewhere
    (reference: src/train_fuse.py:185-189)."""
    valid = q_label != ignore_index
    wt = ((pred0.argmax(-1) != pred1.argmax(-1)) & valid).float()
    wt = torch.where(wt == 0.0, torch.full_like(wt, 0.001), wt)
    tgt = torch.where(valid, q_label, torch.zeros_like(q_label)).long()
    logp = torch.log_softmax(pred.float(), dim=-1)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0] * valid.float()
    return torch.sum(nll * wt) / torch.sum(wt)


def _cat_parts(parts_list) -> Dict:
    """Per-episode parts (each with a leading axis) joined along that axis."""
    first = parts_list[0]
    out = {}
    for k, v in first.items():
        if isinstance(v, dict):
            out[k] = {st: [torch.cat([p[k][st][j] for p in parts_list])
                           for j in range(len(ts))] for st, ts in v.items()}
        elif v.ndim > 0 and k != "w":
            out[k] = torch.cat([p[k] for p in parts_list])
    return out


def _cast_floats(tree, dtype: torch.dtype):
    """Every floating tensor of a nest of dicts and lists cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floats(v, dtype) for v in tree)
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(dtype)
    return tree
