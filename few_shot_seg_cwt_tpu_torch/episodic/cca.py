"""Incremental multi-way episodic training (CCA): base classes + one novel class.

Counterpart of ``few_shot_seg_cwt_tpu.episodic.cca`` (reference:
src/train_cca.py:100-200, src/train_cca1.py), the MMN head over a K-way
episodic classifier:

* the classifier is K-way (``num_classes_tr``): its rows start as the
  stage-1 classifier's (``effective_classifier_weight`` of the backbone),
  and the row of the episode's class ``cls`` is re-seeded, U(+-1/sqrt(C))
  (reset_cls_wt, src/model/model_util.py:112-117). The row is drawn from a
  ``torch.Generator`` or injected (``new_row=`` to ``episode_parts``, or
  the whole init as ``w0=``), so tests can hand the engine the JAX draw;
* the support's BG pixels are pseudo-labelled with the base classifier's
  argmax, the novel logit suppressed (``reset_spt_label`` on the
  align-corners-upsampled base logits, src:119-127);
* the inner loop is the generic autograd loop
  (``inner_loop.adapt_classifier``, ``fast_binary=False``; K1 is K=2 only)
  on Adapt_SegLoss: CE with weight (bg/fg)**tp on the novel class
  (``class_balance_weights``, src/model/pspnet.py:207-221);
* the query predictions are compressed to binary foreground-vs-rest
  probabilities before the loss and the metrics (``compress_pred``,
  src:158-166). The loss is ``seg_loss`` on those probabilities (``pb``):
  for the CE loss types that runs log-softmax on probabilities, the
  reference's own wart (its weighted_ce_loss does the same,
  model_util.py:27-37 via train_cca.py:182-188); the shipped configs use
  ``wt_dc``, which reads ``pb`` as it should.

The MMN readout runs per shot (``HeadEngine._mmn_att_shots``) and is
averaged over every shot (the reference's mean, unlike the MMN engine's
valid-shot mean). ``loss_shot sum``, ``aux``, ``use_amp`` (the head in
bf16 in the train step, its tail fp32) and ``remat_head`` (a checkpoint of
the head's forward) are honoured as in JAX. The consensus runs on the
pivot kernels (on rank-4 cuDNN plane convs under ``FSS_NCONS_INT8``). Serving
(``predict_batch``, ``serve_batch``) gives the argmax of the blended
compressed prediction without reading the query label; the JAX engine
inherits a serving program that fails on its parts.

``adaptive`` (train_cca1): a host pass before each step
(``adaptive_relabel_batch``) rewrites the support labels and draws the
episode's classifier (src/model/model_util.py:130-155): foreground is
class 1, inherited base rows start at 2, unused rows leave the softmax
(``row_mask``; the reference builds a narrower classifier per episode).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..models.pspnet import apply_classifier, effective_classifier_weight, init_classifier_weights
from ..ops.episode_utils import adapt_reset_spt_label_np, compress_pred, reset_spt_label
from ..ops.losses import class_balance_weights, seg_loss
from ..ops.metrics import intersection_and_union
from ..ops.resize import upsample_bilinear_ac
from .engine import episodes_to_device
from .heads import HeadEngine, _cast_floats, head_remat_default
from .inner_loop import adapt_classifier


class CCAEngine(HeadEngine):
    """The MMN head over an incremental K-way episodic classifier."""

    def __init__(self, cfg, adaptive: bool = False, backbone=None, head=None, device="cuda"):
        super().__init__(cfg, "mmn", backbone=backbone, head=head, device=device)
        self.adaptive = adaptive
        self.tp = float(cfg.get("tp", 1.0))

    # ------------------------------------------------------------------ #
    # inputs and the prologue
    # ------------------------------------------------------------------ #

    def to_device(self, episodes: Dict) -> Dict[str, torch.Tensor]:
        """The episode fields, and under ``adaptive`` the host pass's ``w0``
        (E, K, C) and ``row_mask`` (E, K)."""
        batch = episodes_to_device(episodes, self.device)
        for key, dtype in (("w0", torch.float32), ("row_mask", torch.bool)):
            if key in episodes:
                v = episodes[key]
                v = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
                batch[key] = v.to(self.device).to(dtype)
        return batch

    def base_weight(self) -> torch.Tensor:
        """The stage-1 classifier's (K, C) weight, fp32."""
        return effective_classifier_weight(self.backbone).detach().float()

    def new_rows(self, e: int, generator: torch.Generator,
                 shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
        """(E, C) novel-class rows, U(+-1/sqrt(C)) from ``generator`` on the
        host; under a process group the global batch's rows are drawn and
        rank ``shard[0]``'s kept (the JAX step splits one key over it)."""
        rank, world = shard
        rows = torch.stack([init_classifier_weights(generator, 1, self.cfg.bottleneck_dim)[0]
                            for _ in range(e * world)])
        return rows[rank * e:(rank + 1) * e].to(self.device)

    def _prologue(self, batch, generator, w0, shard=(0, 1)) -> Dict:
        return self.episode_parts(batch, w0=w0, generator=generator, shard=shard)

    @staticmethod
    def _masked_cls(w: torch.Tensor, feat: torch.Tensor,
                    row_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """Classifier logits with the unused rows out of the softmax."""
        logits = apply_classifier(w, feat)
        if row_mask is not None:
            logits = torch.where(row_mask, logits, torch.full_like(logits, -1e9))
        return logits

    @torch.no_grad()
    def episode_parts(self, batch: Dict[str, torch.Tensor], w0: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      new_row: Optional[torch.Tensor] = None,
                      shard: Tuple[int, int] = (0, 1)) -> Dict:
        """Backbone features (one pass over the batch) and the adapted K-way
        classifier of E episodes.

        The init: under ``adaptive`` the batch's ``w0`` and ``row_mask``
        (``adaptive_relabel_batch``); else ``w0`` (E, K, C) as given, or the
        stage-1 weight with row ``cls`` set to ``new_row`` (E, C), drawn
        from ``generator`` when not given. Returns f_s (E, shot, h, w, C),
        f_q (E, h, w, C), fs_feats / fq_feats as ``HeadEngine``'s, w (E, K,
        C), s_label (E, shot, H, W) the support labels the loop trained on
        (pseudo-labelled), fg_idx (E,), row_mask (E, K) or None, pd_q0 (E,
        h, w, K) and pd_s (E, shot, h, w, K)."""
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
        cls = batch["cls"]
        pre_w = self.base_weight()
        k = pre_w.shape[0]
        row_mask = None
        if self.adaptive:
            w0, row_mask, s_label = batch["w0"], batch["row_mask"], batch["s_label"]
            fg_idx = torch.ones_like(cls)
        else:
            if w0 is None:
                if new_row is None:
                    if generator is None:
                        raise ValueError("pass a torch.Generator, new_row or w0")
                    new_row = self.new_rows(e, generator, shard)
                w0 = pre_w.expand(e, k, pre_w.shape[1]).clone()
                w0[torch.arange(e, device=w0.device), cls] = new_row.to(w0)
            # the support's BG pseudo-labelled by the base classifier
            size = tuple(batch["s_label"].shape[-2:])
            base = upsample_bilinear_ac(apply_classifier(pre_w, f_s.flatten(0, 1)), size)
            base = base.reshape((e, shot) + base.shape[1:])
            s_label = torch.stack([reset_spt_label(batch["s_label"][i], base[i], int(cls[i]))
                                   for i in range(e)])
            fg_idx = cls
        w0 = torch.as_tensor(w0, dtype=torch.float32).to(f_s.device)
        ws, pd_s = [], []
        for i in range(e):
            rm = None if row_mask is None else row_mask[i]
            weights = class_balance_weights(s_label[i], num_classes=k, fg_idx=int(fg_idx[i]),
                                            tp=self.tp)
            w = adapt_classifier(f_s[i], s_label[i], w0[i], num_steps=self.cfg.adapt_iter,
                                 lr=self.cfg.cls_lr, cls_weights=weights, fast_binary=False,
                                 row_mask=rm)
            ws.append(w)
            pd_s.append(self._masked_cls(w, f_s[i], rm))
        w = torch.stack(ws)
        return dict(f_s=f_s, f_q=f_q, fs_feats=fs_feats, fq_feats=fq_feats, w=w,
                    s_label=s_label, fg_idx=fg_idx, row_mask=row_mask,
                    pd_q0=self._masked_cls(w, f_q, None if row_mask is None
                                           else row_mask[:, None, None, :]),
                    pd_s=torch.stack(pd_s))

    @staticmethod
    def _one(parts: Dict, batch: Dict, i: int) -> Tuple[Dict, Dict]:
        """Episode i of batched parts and inputs, in the JAX per-episode shapes."""
        part = dict(f_s=parts["f_s"][i], f_q=parts["f_q"][i:i + 1],
                    fs_feats={k: [t[i] for t in v] for k, v in parts["fs_feats"].items()},
                    fq_feats={k: [t[i:i + 1] for t in v] for k, v in parts["fq_feats"].items()},
                    w=parts["w"][i], s_label=parts["s_label"][i], fg_idx=parts["fg_idx"][i],
                    row_mask=None if parts["row_mask"] is None else parts["row_mask"][i],
                    pd_q0=parts["pd_q0"][i:i + 1], pd_s=parts["pd_s"][i])
        return part, {k: v[i] for k, v in batch.items()}

    # ------------------------------------------------------------------ #
    # the loss, the train step and evaluation
    # ------------------------------------------------------------------ #

    def _binary_up(self, parts: Dict, feat: torch.Tensor) -> torch.Tensor:
        """The classifier on ``feat`` (unused rows masked), upsampled in fp32
        and compressed to binary probabilities, foreground ``fg_idx``."""
        logits = self._masked_cls(parts["w"], feat, parts["row_mask"])
        return compress_pred(self._up(logits), parts["fg_idx"], "lg")

    def _readout(self, parts: Dict, det: bool) -> torch.Tensor:
        """The MMN readouts of every shot, (shot, h, w, C) fp32. Under
        ``use_amp`` (train step) the head's inputs go to bf16 here (its
        parameters in ``_amp_head``); ``remat_head`` checkpoints it."""
        head_in = (parts["fq_feats"], parts["fs_feats"], parts["f_q"], parts["f_s"])
        if self.cfg.get("use_amp", False) and not det:
            head_in = _cast_floats(head_in, torch.bfloat16)

        def head_fwd(fq_feats, fs_feats, f_q, f_s):
            return self._mmn_att_shots(fq_feats, fs_feats, f_q, f_s, det)

        if head_remat_default(self.cfg, self.head_type) and not det and torch.is_grad_enabled():
            return checkpoint(head_fwd, *head_in, use_reentrant=False).float()
        return head_fwd(*head_in).float()

    def _preds(self, parts: Dict, det: bool):
        """(per-shot readouts, {"pred0", "pred1", "pred"}): the compressed
        (H, W, 2) predictions of the raw classifier, the readout averaged
        over every shot (the reference's mean) and its blend into the query
        feature. The query label is not read."""
        att_shots = self._readout(parts, det)
        att_fq = att_shots.mean(dim=0, keepdim=True)
        fq_blend = parts["f_q"] * (1 - self.cfg.att_wt) + att_fq * self.cfg.att_wt
        return att_shots, {"pred0": self._binary_up(parts, parts["f_q"])[0],
                           "pred1": self._binary_up(parts, att_fq)[0],
                           "pred": self._binary_up(parts, fq_blend)[0]}

    def train_episode_loss(self, parts: Dict, episode: Dict, deterministic: bool = False):
        """One episode's loss (differentiable in the head's parameters) and
        its metrics: I/U over 2 classes of the compressed raw (``0``),
        readout (``1``) and blended predictions."""
        cfg = self.cfg
        q_label = episode["q_label"]

        def crit(probs):
            return seg_loss(probs, q_label, loss_type=cfg.get("loss_type", "wt_ce"),
                            input_type="pb")

        att_shots, preds = self._preds(parts, deterministic)
        if cfg.get("loss_shot", "avg") == "sum":
            per_shot = self._binary_up(parts, att_shots)
            loss = sum(crit(per_shot[k]) for k in range(per_shot.shape[0]))
        else:
            loss = crit(preds["pred1"])
        aux = cfg.get("aux", False)
        if aux:
            loss = loss + aux * crit(preds["pred"])
        loss = loss.float()
        metrics = {"loss": loss.detach()}
        with torch.no_grad():
            for name, key in (("0", "pred0"), ("1", "pred1"), ("", "pred")):
                inter, union, _ = intersection_and_union(preds[key].argmax(-1), q_label, 2)
                metrics[f"inter{name}"], metrics[f"union{name}"] = inter, union
        return loss, metrics

    @torch.no_grad()
    def eval_metrics_batch(self, episodes, generator: Optional[torch.Generator] = None,
                           w0: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The deterministic loss and the binary I/U of E episodes, one at a
        time (the JAX ``lax.map``), plus ``cls``; (E, ...) each."""
        batch = self.to_device(episodes)
        parts = self._prologue(batch, generator, w0)
        outs = [self.train_episode_loss(*self._one(parts, batch, i), deterministic=True)[1]
                for i in range(batch["q_img"].shape[0])]
        out = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        out["cls"] = batch["cls"]
        return out

    @torch.no_grad()
    def predict_batch(self, episodes, generator: Optional[torch.Generator] = None,
                      w0: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Label-free deterministic predictions for E episodes: ``pred1`` and
        ``pred``, the compressed (E, H, W, 2) probabilities; ``serve_batch``
        takes the argmax of ``pred``. (The JAX ``CCAEngine`` inherits a
        serving program that fails on its parts; this one reads what its
        eval reads, less the query label.)"""
        batch = self.to_device({k: v for k, v in episodes.items() if k != "q_label"})
        parts = self._prologue(batch, generator, w0)
        preds = [self._preds(self._one(parts, batch, i)[0], True)[1]
                 for i in range(batch["q_img"].shape[0])]
        return {k: torch.stack([p[k] for p in preds]) for k in ("pred1", "pred")}


def make_base_preds_fn(cfg, engine: CCAEngine):
    """The base classifier's support predictions for the adaptive host pass:
    (shot, H, W, 3) images -> (shot, size, size, K) upsampled logits."""

    @torch.no_grad()
    def base_preds(s_img) -> torch.Tensor:
        s_img = torch.as_tensor(np.asarray(s_img) if not torch.is_tensor(s_img) else s_img)
        out = engine.backbone.extract_features(s_img.to(engine.device).float())
        feat = (out[0] if isinstance(out, tuple) else out).float()
        logits = apply_classifier(engine.base_weight(), feat)
        return upsample_bilinear_ac(logits, (cfg.image_size, cfg.image_size))

    return base_preds


def adaptive_relabel_batch(cfg, engine: CCAEngine, batch: Dict, base_preds_fn,
                           rng: np.random.Generator) -> Dict:
    """The cca1 host pass (src/train_cca1.py:144): per episode the rewritten
    support labels and a fresh classifier, rows drawn uniform +-1/sqrt(C)
    from ``rng`` (torch Conv2d's init), rows 2..num_cls-1 the inherited
    base-class weights, row 0 the base BG row under ``load_bg``; the other
    rows leave the softmax (``row_mask``). The batch may hold numpy arrays
    or tensors on the card; the labels, inits and masks come back as numpy
    (``to_device`` moves them): the same ``rng`` gives JAX's draws bit for
    bit."""
    e = len(batch["s_img"])
    k, c = int(cfg.num_classes_tr), int(cfg.bottleneck_dim)
    pre_w = engine.base_weight().cpu().numpy()
    bound = 1.0 / np.sqrt(c)
    s_label, cls = _host(batch["s_label"]), _host(batch["cls"])
    labels, w0s, masks = [], [], []
    for i in range(e):
        new_lab, cls_init_wt, num_cls = adapt_reset_spt_label_np(
            s_label[i], _host(base_preds_fn(batch["s_img"][i])), pre_w, k,
            sub_cls=int(cls[i]))
        w0 = rng.uniform(-bound, bound, size=(k, c)).astype(np.float32)
        for j, wt in enumerate(cls_init_wt):
            w0[2 + j] = wt
        if cfg.get("load_bg", False):
            w0[0] = pre_w[0]      # the BG row from the base classifier (src/train_cca1.py:150-151)
        mask = np.zeros(k, bool)
        mask[:num_cls] = True
        labels.append(new_lab)
        w0s.append(w0)
        masks.append(mask)
    out = dict(batch)
    out["s_label"] = np.stack(labels)
    out["w0"] = np.stack(w0s)
    out["row_mask"] = np.stack(masks)
    return out


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
