"""Seeded one-shot episodes, made on the device in a few large calls.

Each episode has a class colour: its support and its query each hold one
object, an ellipse of that colour over a textured background (smooth noise
plus fine noise, in normalised units), labelled 1 inside, 0 outside and
255 on a thin band along its outline (VOC's boundary ignore). Every seed
gives the same sizes and the same number of episodes; only the content
moves. Every image holds foreground and background, so no classifier
weight ([1, n_bg / n_fg]) is infinite. ``screened`` draws anew every
episode whose inner loop is chaotic, so that each seed's pool is of one
difficulty.
"""

from __future__ import annotations

import sys
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..reference import cwt as ref_cwt
from ..reference import pspnet as ref_pspnet

# the screen's noise has a generator of its own: a pool with nothing to
# replace is exactly the pool drawn from the seed
SCREEN_NOISE_SEED = 20211010


def _images_and_labels(gen: torch.Generator, n: int, size: int, colour: torch.Tensor,
                       device) -> Dict[str, torch.Tensor]:
    """n images (n, H, W, 3) float32 and labels (n, H, W) int64."""
    u = torch.rand((n, 5), generator=gen, device=device)
    cy, cx = (0.3 + 0.4 * u[:, 0]) * size, (0.3 + 0.4 * u[:, 1]) * size
    ry, rx = (0.12 + 0.18 * u[:, 2]) * size, (0.12 + 0.18 * u[:, 3]) * size
    ys = torch.arange(size, device=device, dtype=torch.float32)
    r = torch.sqrt(((ys[None, :, None] - cy[:, None, None]) / ry[:, None, None]) ** 2
                   + ((ys[None, None, :] - cx[:, None, None]) / rx[:, None, None]) ** 2)
    label = (r < 1.0).long()
    label = torch.where((r - 1.0).abs() < 0.04, torch.full_like(label, 255), label)
    coarse = torch.randn((n, 3, 16, 16), generator=gen, device=device)
    img = F.interpolate(coarse, (size, size), mode="bilinear", align_corners=True)
    img = img + 0.5 * torch.randn((n, 3, size, size), generator=gen, device=device)
    img = img.permute(0, 2, 3, 1) + (r < 1.0).float()[..., None] * colour[:, None, None, :]
    return {"img": img.contiguous(), "label": label}


def episodes(gen: torch.Generator, n: int, size: int, device) -> Dict[str, torch.Tensor]:
    """n one-shot episodes as the engines take them: s_img (n, 1, H, W, 3),
    s_label (n, 1, H, W), q_img (n, H, W, 3), q_label (n, H, W), cls (n,)."""
    colour = 1.5 * torch.randn((n, 3), generator=gen, device=device)
    s = _images_and_labels(gen, n, size, colour, device)
    q = _images_and_labels(gen, n, size, colour, device)
    cls = torch.randint(1, 16, (n,), generator=gen, device=device)
    return {"s_img": s["img"][:, None], "s_label": s["label"][:, None],
            "q_img": q["img"], "q_label": q["label"], "cls": cls}


def classifier_inits(gen: torch.Generator, n: int, classes: int, dim: int,
                     device) -> torch.Tensor:
    """(n, K, C) fresh episodic classifiers, U(+-1/sqrt(C)) (torch's 1x1
    conv init)."""
    bound = dim ** -0.5
    return (torch.rand((n, classes, dim), generator=gen, device=device) * 2 - 1) * bound


def _upsampling(n_out: int, n_in: int, device) -> torch.Tensor:
    """(n_out, n_in): bilinear, align-corners interpolation along one axis."""
    if n_in == 1:
        return torch.ones((n_out, 1), device=device)
    pos = torch.arange(n_out, dtype=torch.float64) * (n_in - 1) / max(n_out - 1, 1)
    lo = pos.floor().long().clamp(max=n_in - 2)
    frac = pos - lo
    m = torch.zeros((n_out, n_in), dtype=torch.float64)
    rows = torch.arange(n_out)
    m[rows, lo] = 1 - frac
    m[rows, lo + 1] += frac
    return m.float().to(device)


def _adapt(f_s: torch.Tensor, s_label: torch.Tensor, w0: torch.Tensor, steps: int,
           lr: float) -> torch.Tensor:
    """``ref_cwt.adapt``'s plain SGD on the class-weighted cross-entropy,
    its gradient written out and the upsampling as two matrix products,
    so that a seed's screen decides alike in every run (autograd's
    upsampling backward adds with atomics, in no fixed order)."""
    _, h, wd, _ = f_s.shape
    size_h, size_w = s_label.shape[-2:]
    a_h, a_w = _upsampling(size_h, h, f_s.device), _upsampling(size_w, wd, f_s.device)
    valid = s_label != 255
    tgt = torch.where(valid, s_label, torch.zeros_like(s_label)).long()
    weight = torch.gather(ref_cwt.class_weights(s_label), 1, tgt.flatten(1)).reshape(tgt.shape)
    weight = weight * valid
    weight = weight / weight.flatten(1).sum(1).clamp(min=1e-12)[:, None, None]
    onehot = F.one_hot(tgt, w0.shape[1]).permute(0, 3, 1, 2).float()
    w = w0.clone()
    for _ in range(steps):
        up = a_h @ torch.einsum("ehwc,ekc->ekhw", f_s, w) @ a_w.t()
        d_up = (torch.softmax(up, dim=1) - onehot) * weight[:, None]
        w = w - lr * torch.einsum("ekhw,ehwc->ekc", a_h.t() @ d_up @ a_w, f_s)
    return w


def screened(gen: torch.Generator, pool: Dict[str, torch.Tensor], w0: torch.Tensor, sd,
             cfg, device, tol: float = 1e-5, chunk: int = 8,
             rounds: int = 8) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(pool, w0) with every episode whose 1-shot inner loop is chaotic
    drawn anew from ``gen``, with its classifier init.

    At the configurations' step (``cls_lr`` 0.1, 200 steps) the inner loop
    overshoots in its first steps, and on a few episodes the run that
    follows is chaotic: a relative change of 1e-6 in the support features
    moves the adapted classifier by several per cent, and two fp32
    computations of the episode, the program's and the reference's, part
    as far (PERF.md, §2). Such an episode has no fp32 answer to compare.
    The screen runs each episode's inner loop (``_adapt``) on the
    reference's support features and on the features times (1 + 1e-6
    noise); where the two classifiers differ by more than ``tol`` of their
    norm, the episode is replaced. Sizes and counts stay as drawn. Prints
    one line to standard error.
    """
    n = w0.shape[0]
    noise_gen = torch.Generator(device=device)
    noise_gen.manual_seed(SCREEN_NOISE_SEED)
    todo, replaced, kept = list(range(n)), 0, 0.0
    for _ in range(rounds):
        bad = []
        for lo in range(0, len(todo), chunk):
            idx = torch.tensor(todo[lo:lo + chunk], device=device)
            f = ref_pspnet.features(sd, pool["s_img"][idx, 0], cfg.layers)[0]
            noisy = f * (1 + 1e-6 * torch.randn(f.shape, generator=noise_gen, device=device))
            lab = pool["s_label"][idx, 0]
            w = _adapt(torch.cat([f, noisy]), torch.cat([lab, lab]),
                       torch.cat([w0[idx], w0[idx]]), cfg.adapt_iter, cfg.cls_lr)
            k = len(idx)
            gap = (w[:k] - w[k:]).flatten(1).norm(dim=1) / w[:k].flatten(1).norm(dim=1)
            for i, g in zip(idx.tolist(), gap.tolist()):
                if g > tol:
                    bad.append(i)
                else:
                    kept = max(kept, g)
        if not bad:
            print(f"screen: {n} episodes, {replaced} drawn anew, kept classifier gaps "
                  f"<= {kept:.3g} (limit {tol:g})", file=sys.stderr)
            return pool, w0
        replaced += len(bad)
        at = torch.tensor(bad, device=device)
        fresh = episodes(gen, len(bad), pool["q_img"].shape[1], device)
        for key, value in fresh.items():
            pool[key][at] = value
        w0[at] = classifier_inits(gen, len(bad), w0.shape[1], w0.shape[2], device)
        todo = bad
    raise RuntimeError(f"{len(todo)} of {n} episodes still chaotic after {rounds} draws")
