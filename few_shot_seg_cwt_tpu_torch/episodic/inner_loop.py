"""Episodic classifier adaptation (the inner loop).

Counterpart of ``few_shot_seg_cwt_tpu.episodic.inner_loop``. The reference
trains a fresh (K, 512) 1x1 classifier for ``adapt_iter`` SGD steps on the
support features, with CE at label resolution after align-corners upsampling,
per-episode class weights [1, n_bg/n_fg] and ignore index 255.

* ``adapt_classifier`` is the generic path: an autograd loop over
  ``support_loss`` (with ``row_mask``), one episode at a time.
* For K=2 without ``row_mask`` the loop has a closed form that evolves one
  (C,) accumulator (see ``_adapt_binary``); ``adapt_binary_batch`` runs it for
  a batch of episodes through ``ops.cuda_inner_loop.adapt_binary`` (K1) or,
  when ``pick_tile`` says so, ``adapt_binary_tiled`` (K2). Each launches its
  CUDA kernel on the card and runs the plain version on the CPU.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from ..ops.cuda_inner_loop import (MAX_SMEM_BYTES, TILES, adapt_binary,
                                   adapt_binary_tiled, smem_bytes)
from ..ops.losses import class_balance_weights, weighted_cross_entropy
from ..ops.resize import upsample_bilinear_ac


def support_loss(
    w: torch.Tensor,              # (K, C) classifier weights
    f_s: torch.Tensor,            # (shot, h, w, C) support features
    s_label: torch.Tensor,        # (shot, H, W) int labels in {0, 1, 255}
    cls_weights: torch.Tensor,    # (K,) CE class weights
    row_mask: Optional[torch.Tensor] = None,  # (K,) bool; False rows excluded
) -> torch.Tensor:
    logits = torch.einsum("shwc,kc->shwk", f_s, w)
    if row_mask is not None:
        # emulate a narrower classifier: masked rows leave the softmax
        logits = torch.where(row_mask, logits, torch.full_like(logits, -1e9))
    logits = upsample_bilinear_ac(logits, tuple(s_label.shape[-2:]))
    return weighted_cross_entropy(logits, s_label, cls_weights)


def adapt_classifier(
    f_s: torch.Tensor,
    s_label: torch.Tensor,
    w_init: torch.Tensor,
    num_steps: int = 200,
    lr: float = 0.0025,
    cls_weights: Optional[torch.Tensor] = None,
    fast_binary: bool = True,
    row_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run one episode's inner loop; returns the adapted (K, C) weights.

    Plain SGD (no momentum). For K=2 without ``row_mask`` the closed form is
    used; ``fast_binary=False`` forces the generic autograd loop.
    """
    if cls_weights is None:
        cls_weights = class_balance_weights(s_label, num_classes=w_init.shape[0])
    if fast_binary and w_init.shape[0] == 2 and row_mask is None:
        return _adapt_binary(f_s, s_label, w_init, num_steps, lr, cls_weights)
    w = w_init.detach().clone()
    with torch.enable_grad():
        for _ in range(num_steps):
            w.requires_grad_(True)
            loss = support_loss(w, f_s, s_label, cls_weights, row_mask)
            (g,) = torch.autograd.grad(loss, w)
            w = (w - lr * g).detach()
    return w


def binary_pixel_weights(s_label: torch.Tensor,
                         cls_weights: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalised pixel weights pw and pw*y of the K=2 closed form.

    s_label (E, shot, H, W). pw is the CE weight of each pixel (class weight,
    0 where the label is 255) divided by the episode's weight sum, so the
    weighted-CE mean is folded in. ``cls_weights`` (E, 2) defaults to each
    episode's [1, n_bg/n_fg].
    """
    valid = s_label != 255
    fg = s_label == 1
    dims = tuple(range(1, s_label.ndim))
    if cls_weights is None:
        fg_cnt = fg.sum(dim=dims).float()
        bg_cnt = valid.sum(dim=dims).float() - fg_cnt
        w_fg = bg_cnt / torch.clamp(fg_cnt, min=1e-12)
        cls_weights = torch.stack([torch.ones_like(w_fg), w_fg], dim=-1)
    bshape = (-1,) + (1,) * (s_label.ndim - 1)
    pw = torch.where(fg, cls_weights[:, 1].reshape(bshape),
                     cls_weights[:, 0].reshape(bshape)) * valid.float()
    pw = pw / torch.clamp(pw.sum(dim=dims, keepdim=True), min=1e-12)
    return pw.contiguous(), (pw * fg.float()).contiguous()


def pick_tile(e: int, shot: int, h: int, w: int, c: int, big_w: int) -> int:
    """Episodes per CTA of the inner-loop kernel for a batch of ``e``.

    The counterpart of the JAX package's ``_pick_tile``
    (``ops/pallas_inner_loop.py``), with the same switch and rule:
    ``FSS_INNER_TILE`` (default 1) asks for a tile; 1-shot only; try the
    tile asked for, then 2; the batch must divide by the tile. The budget is
    Hopper's 232,448 B of shared memory per block in place of the TPU's
    127 MiB of VMEM: a tile is admitted when the kernel's least layout for
    it (one feature row a CTA, no pinned features: ``smem_bytes``) fits,
    and the tile is one the kernel is built for (2, 3 or 4). The kernel
    streams what it cannot pin, so at 473 px (60x60x512 features) tile 4
    needs 70,016 B and fits, and the port picks what the JAX package picks.
    """
    want = int(os.environ.get("FSS_INNER_TILE", "1"))
    if shot != 1 or want <= 1:
        return 1
    for t in (want, 2):
        if (t in TILES and e % t == 0
                and smem_bytes(h, w, c, big_w, t) <= MAX_SMEM_BYTES):
            return t
    return 1


def adapt_binary_batch(f_s: torch.Tensor, s_label: torch.Tensor,
                       w_init: torch.Tensor, num_steps: int, lr: float,
                       cls_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Closed-form K=2 inner loop for a batch of episodes.

    f_s (E, shot, h, w, C), s_label (E, shot, H, W), w_init (E, 2, C);
    returns the adapted (E, 2, C) weights. The batch runs on K1, or on K2
    when ``pick_tile`` gives a tile above 1 (never for a batch of one, as
    the JAX package's unbatched call runs K1).

    For K=2 the weighted-CE gradient w.r.t. the two logits is
    +-pw*(sigmoid(l1-l0) - y)/sum(pw), so the two rows move in exact
    opposition: W1_t = W1_0 - lr*acc_t, W0_t = W0_0 + lr*acc_t.
    """
    pw, pwy = binary_pixel_weights(s_label, cls_weights)
    u0 = (w_init[:, 1] - w_init[:, 0]).float().contiguous()
    f_s = f_s.float().contiguous()
    e, shot, h, w, c = f_s.shape
    tile = pick_tile(e, shot, h, w, c, pw.shape[-1])
    if tile > 1:
        acc = adapt_binary_tiled(f_s, pw, pwy, u0, num_steps, float(lr), tile)
    else:
        acc = adapt_binary(f_s, pw, pwy, u0, num_steps, float(lr))
    return torch.stack([w_init[:, 0] + lr * acc, w_init[:, 1] - lr * acc], dim=1)


def _adapt_binary(f_s, s_label, w_init, num_steps, lr, cls_weights):
    """One episode through the batched closed form (a batch of one)."""
    return adapt_binary_batch(f_s[None], s_label[None], w_init[None], num_steps,
                              lr, cls_weights[None])[0]


def adapt_classifier_batch(f_s: torch.Tensor, s_label: torch.Tensor,
                           w_init: torch.Tensor, num_steps: int, lr: float
                           ) -> torch.Tensor:
    """Inner loop for E episodes: (E, shot, h, w, C) features, (E, shot, H, W)
    labels, (E, K, C) inits -> (E, K, C). K=2 runs the closed form for the
    whole batch at once; other K run the generic loop episode by episode."""
    if w_init.shape[1] == 2:
        return adapt_binary_batch(f_s, s_label, w_init, num_steps, lr)
    return torch.stack([
        adapt_classifier(f_s[i], s_label[i], w_init[i], num_steps, lr)
        for i in range(w_init.shape[0])
    ])
