"""Plain math of the CHM head's evaluation (Min, Kang and Cho, "Convolutional
Hough Matching Networks", CVPR 2021, arXiv:2103.16831; in the CWT
reference, ``CHMLearner`` of ``src/model/match.py:191-244`` with
``src/model/base/chm.py``, ``chm_kernel.py`` and ``correlation.py``, reached
by ``crm_type chm`` of ``src/train_match.py``), in fp32, on the features of
``pspnet``.

For each episode, on the last block of stage 4 of the query and of the
support, each halved (bilinear, align corners):

* three scale embeddings, a 3x3 conv (no bias) of each image resized to
  ``round(side * sqrt(scale))`` for scales 0.5, 1 and 2;
* nine cosine correlations, each (query scale, support scale) pair's,
  resized to side^4 by a 4D bilinear resize (align corners; the query
  plane first), clamped at 0: the 6D volume (B, 3, 3, side, side, side,
  side);
* CHM6d: a 3x3 kernel over the two scale axes whose every entry is a 5^4
  kernel over the two planes, applied pair by pair: each of the 49 (input
  pair, output pair) links of the 3x3 scale grid convolves the input
  pair's 4D volume with its scale offset's 4D kernel, and an output pair
  sums its links, plus one bias;
* a sigmoid, the max over the nine scale pairs, a 4D bilinear upsample to
  twice the side;
* CHM4d: one 5^4 kernel (one channel in and out) plus a bias, then a
  softplus;
* the mutual nearest-neighbour filter of the (query, support) matrix,
  c * (c / max over the support) * (c / max over the query), a zero max
  taken as 1e-30;
* the readout: the softmax over the support of the filtered matrix times
  ``temp``, times the support's bottleneck features.

The 4D kernels share weights: each 5^4 entry, a (query offset, support
offset) pair, belongs to one "psi" group keyed by the larger and the
smaller of the two offsets' squared distances from the centre and their
squared distance from each other (``chm_kernel.py:KernelGenerator``); a
group's one weight w spreads as w / len(group) over its entries, and in
CHM6d as w / (len(group) * len(scale group)) over the scale offsets of its
scale group: the centre; the two main diagonals' corners; the two
anti-diagonal corners; the four edges.

Every 4D convolution (stride 1, zero padding 2) is a sum over the kernel's
(k0, k1) query offsets of a 2D convolution over the support plane
(``precision.conv2d``), so the TF32 control reaches it.

Departures from the published code, none of which changes the function:
the reference's ``fast4d`` slides conv3d over the query's first axis
(the same sum, in another order); its ``fast6d`` applies the scale kernel
by diagonal sums and a final reversal, a flipped correlation, where this
file applies it unflipped: under the psi grouping the 3x3 scale kernel
and each 5^4 kernel are symmetric under point reflection, so the two are
one function. The cosine divides by the product of the norms clamped at
1e-30 in place of an added epsilon. Eval only: no ignore mask (``ignore
False``). Weights are the benchmark's, not the published init (``schema``).
The episodic classifier is the 1x1 dot classifier of ``cwt.adapt`` whatever
``dist`` says: ``dist cosN`` names the backbone's own classifier, which the
episodes never read.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .cwt import iou, logits_up, weighted_ce
from .precision import conv2d, matmul
from .pspnet import Entry

SCALES = (0.5, 1.0, 2.0)
KSZ4D = 5
KSZ6D = 3
# the 3x3 scale kernel's psi groups of (scale offset along the query's
# scale axis, along the support's): centre, main-diagonal corners,
# anti-diagonal corners, edges
SCALE_GROUPS = (((1, 1),), ((0, 0), (2, 2)), ((0, 2), (2, 0)),
                ((0, 1), (1, 0), (1, 2), (2, 1)))
# the per-entry scale of the seeded group weights (``schema``): each 4D
# kernel entry of CHM6d and of CHM4d is |N(0, 1)| times this
TAP_SCALE_6D = 4e-3
TAP_SCALE_4D = 4e-3


def _d2(a: Tuple[int, int], b: Tuple[int, int]) -> int:
    return (a[0] - b[0]) ** 2 + (a[1] - b[1]) ** 2


@functools.lru_cache(maxsize=None)
def kernel_groups(ksz: int = KSZ4D) -> Tuple[Tuple[Tuple[int, int, int, int], ...], ...]:
    """The psi groups of a ksz^4 kernel, each a tuple of (q0, q1, s0, s1)
    entries (query offset, support offset), in the order a group is first
    met when the query offset's rows, then its columns, then the support
    offset's rows and columns are walked, each outer to the next: the
    order of the published ``KernelGenerator``'s dictionary, which names
    the weights."""
    c = (ksz // 2, ksz // 2)
    groups: Dict[Tuple[int, int, int], List[Tuple[int, int, int, int]]] = {}
    for q0 in range(ksz):
        for q1 in range(ksz):
            for s0 in range(ksz):
                for s1 in range(ksz):
                    dq, ds = _d2((q0, q1), c), _d2((s0, s1), c)
                    key = (max(dq, ds), min(dq, ds), _d2((q0, q1), (s0, s1)))
                    groups.setdefault(key, []).append((q0, q1, s0, s1))
    return tuple(tuple(g) for g in groups.values())


@functools.lru_cache(maxsize=None)
def _entry_groups(ksz: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """For each kernel entry in (q0, q1, s0, s1) order: its group and the
    group's size."""
    group, size = [0] * ksz ** 4, [0] * ksz ** 4
    for g, members in enumerate(kernel_groups(ksz)):
        for q0, q1, s0, s1 in members:
            flat = ((q0 * ksz + q1) * ksz + s0) * ksz + s1
            group[flat], size[flat] = g, len(members)
    return tuple(group), tuple(size)


def kernel4d(weights: torch.Tensor, divide: float = 1.0, ksz: int = KSZ4D) -> torch.Tensor:
    """(n_groups,) shared weights -> the (ksz, ksz, ksz, ksz) kernel: each
    entry its group's weight over (len(group) * ``divide``)."""
    group, size = _entry_groups(ksz)
    gid = torch.tensor(group, device=weights.device)
    den = torch.tensor(size, dtype=weights.dtype, device=weights.device) * divide
    return (weights[gid] / den).reshape((ksz,) * 4)


def schema(in_dim: int = 2048, feat_dim: int = 2048) -> List[Entry]:
    """The head's parameters under the program's names: the three scale
    convs (feat_dim // 4, in_dim, 3, 3) normal with std 1/sqrt(fan_in)
    (flax's lecun normal, untruncated); CHM6d's four scale groups' weights
    and CHM4d's, a normal draw per group that ``live_groups`` turns into
    the published init's form at ``TAP_SCALE_*`` in place of its 1e-3; two
    zero biases, which ``calibrate`` sets."""
    n = len(kernel_groups())
    out: List[Entry] = [(f"scale_conv_{i}.weight", (feat_dim // 4, in_dim, 3, 3), "normal",
                         1.0 / math.sqrt(in_dim * 9)) for i in range(len(SCALES))]
    out += [(f"chm6d.param_{i}", (n,), "normal", TAP_SCALE_6D)
            for i in range(len(SCALE_GROUPS))]
    out += [("chm6d.bias", (), "const", 0.0),
            ("chm4d.weight", (n,), "normal", TAP_SCALE_4D),
            ("chm4d.bias", (), "const", 0.0)]
    return out


@torch.no_grad()
def live_groups(p: Dict[str, torch.Tensor]) -> None:
    """In place: each group weight drawn by ``schema`` becomes |draw| *
    len(group) * len(scale group) (1 for CHM4d), the published init's form
    (|N(0, 1)| * 1e-3 * len(group) * n_scale), so that every kernel entry
    is |N(0, 1)| times its tap scale, positive as Hough votes are."""
    lens = torch.tensor([float(len(g)) for g in kernel_groups()],
                        device=p["chm4d.weight"].device)
    for i, sg in enumerate(SCALE_GROUPS):
        p[f"chm6d.param_{i}"].abs_().mul_(lens * len(sg))
    p["chm4d.weight"].abs_().mul_(lens)


def resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear, align-corners resize of (B, h, w, C) to (B, size, size, C)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), (size, size), mode="bilinear", align_corners=True)
    return y.permute(0, 2, 3, 1)


def interpolate4d(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, h1, w1, h2, w2) -> (B, size, size, size, size): the query plane
    resized (bilinear, align corners), then the support plane."""
    b, h1, w1, h2, w2 = x.shape
    y = F.interpolate(x.reshape(b, h1, w1, h2 * w2).permute(0, 3, 1, 2), (size, size),
                      mode="bilinear", align_corners=True)            # (B, h2*w2, S, S)
    y = y.reshape(b, h2, w2, size * size).permute(0, 3, 1, 2)          # (B, S*S, h2, w2)
    y = F.interpolate(y, (size, size), mode="bilinear", align_corners=True)
    return y.reshape(b, size, size, size, size)


def correlation6d(p: Dict[str, torch.Tensor], fq: torch.Tensor, fs: torch.Tensor,
                  scales: Sequence[float] = SCALES) -> torch.Tensor:
    """Halved taps (B, side, side, C) of the query and the support -> the
    6D volume (B, S, S, side, side, side, side), query scale first."""
    b, side = fq.shape[:2]
    embedded = {"q": [], "s": []}
    for i, scale in enumerate(scales):
        n = round(side * math.sqrt(scale))
        for key, f in (("q", fq), ("s", fs)):
            x = resize(f, n).permute(0, 3, 1, 2)
            e = conv2d(x, p[f"scale_conv_{i}.weight"], padding=1)       # (B, C', n, n)
            embedded[key].append(e.flatten(2).transpose(1, 2))         # (B, n*n, C')
    vols = []
    for q in embedded["q"]:
        for s in embedded["s"]:
            norms = q.norm(dim=2)[:, :, None] * s.norm(dim=2)[:, None, :]
            corr = matmul(q, s.transpose(1, 2)) / norms.clamp(min=1e-30)
            nq, ns = math.isqrt(q.shape[1]), math.isqrt(s.shape[1])
            vols.append(interpolate4d(corr.reshape(b, nq, nq, ns, ns), side))
    n = len(scales)
    out = torch.stack(vols, dim=1).reshape((b, n, n) + (side,) * 4)
    return out.clamp(min=0.0)


def conv4d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Stride-1 4D convolution with zero padding k // 2: x (N, Ci, h, w, hs,
    ws), kernel (Co, Ci, k0, k1, k2, k3) -> (N, Co, h, w, hs, ws), as the sum
    over the query offsets (p, q) of a 2D convolution over the support
    plane of the query-shifted volume."""
    n, ci, h, w, hs, ws = x.shape
    co, _, k0, k1, k2, k3 = kernel.shape
    xp = F.pad(x, (0, 0, 0, 0, k1 // 2, k1 // 2, k0 // 2, k0 // 2))
    out = None
    for a in range(k0):
        for c in range(k1):
            t = xp[:, :, a:a + h, c:c + w].permute(0, 2, 3, 1, 4, 5).reshape(n * h * w, ci, hs, ws)
            o = conv2d(t, kernel[:, :, a, c], padding=(k2 // 2, k3 // 2))
            out = o if out is None else out + o
    return out.reshape(n, h, w, co, hs, ws).permute(0, 3, 1, 2, 4, 5)


def scale_kernels(p: Dict[str, torch.Tensor]) -> Dict[Tuple[int, int], torch.Tensor]:
    """{scale offset (da, db): its 5^4 kernel} of CHM6d."""
    out = {}
    for i, sg in enumerate(SCALE_GROUPS):
        k = kernel4d(p[f"chm6d.param_{i}"], divide=len(sg))
        for offset in sg:
            out[offset] = k
    return out


def scale_links(s: int = 3, ksz: int = KSZ6D) -> List[Tuple[Tuple[int, int], Tuple[int, int],
                                                             Tuple[int, int]]]:
    """The (input pair, output pair, scale offset) links of the s x s scale
    grid under a ksz x ksz kernel with zero padding: output pair (a, b)
    reads input pair (a + da - pad, b + db - pad) through offset (da, db)."""
    pad = ksz // 2
    out = []
    for a in range(s):
        for b in range(s):
            for da in range(ksz):
                for db in range(ksz):
                    i, j = a + da - pad, b + db - pad
                    if 0 <= i < s and 0 <= j < s:
                        out.append(((i, j), (a, b), (da, db)))
    return out


def chm6d(p: Dict[str, torch.Tensor], corr: torch.Tensor) -> torch.Tensor:
    """(B, S, S, h, w, hs, ws) -> CHM6d's pre-activation, same shape: per
    input pair one 4D conv of its volume with the kernels of the offsets
    that link it to an output pair; each output pair sums what its links
    bring, plus the bias."""
    b, s1, s2 = corr.shape[:3]
    kernels = scale_kernels(p)
    out: Dict[Tuple[int, int], torch.Tensor] = {}
    links = scale_links(s1)
    for i in range(s1):
        for j in range(s2):
            mine = [(o, off) for src, o, off in links if src == (i, j)]
            k = torch.stack([kernels[off] for _, off in mine])[:, None]   # (Co, 1, k^4)
            y = conv4d(corr[:, i, j][:, None], k)
            for c, (o, _) in enumerate(mine):
                out[o] = y[:, c] if o not in out else out[o] + y[:, c]
    vol = torch.stack([out[(a, c)] for a in range(s1) for c in range(s2)], dim=1)
    return vol.reshape(corr.shape) + p["chm6d.bias"]


def pool(pre6d: torch.Tensor) -> torch.Tensor:
    """Sigmoid, the max over the scale pairs, the 4D upsample to twice the
    side: (B, S, S, h, w, h, w) -> (B, 2h, 2w, 2h, 2w)."""
    b, s1, s2, h = pre6d.shape[:4]
    x = torch.sigmoid(pre6d).reshape((b, s1 * s2) + pre6d.shape[3:]).amax(dim=1)
    return interpolate4d(x, 2 * h)


def chm4d(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, H, W) -> CHM4d's pre-activation, same shape."""
    k = kernel4d(p["chm4d.weight"])[None, None]
    return conv4d(x[:, None], k)[:, 0] + p["chm4d.bias"]


def mutual_nn_filter(c: torch.Tensor) -> torch.Tensor:
    """(B, Nq, Ns) -> c * (c / its max over the support) * (c / its max over
    the query), a max of exactly 0 taken as 1e-30."""
    src = c.amax(dim=2, keepdim=True)
    trg = c.amax(dim=1, keepdim=True)
    src = torch.where(src == 0, torch.full_like(src, 1e-30), src)
    trg = torch.where(trg == 0, torch.full_like(trg, 1e-30), trg)
    return c * ((c / src) * (c / trg))


def readout(pre4d: torch.Tensor, v: torch.Tensor, temp: float) -> torch.Tensor:
    """Softplus, the mutual filter and the softmax readout: pre4d (B, H, W,
    H, W), support values v (B, H, W, C) -> (B, H, W, C)."""
    b, hh, ww = pre4d.shape[:3]
    n = hh * ww
    corr = mutual_nn_filter(F.softplus(pre4d).reshape(b, n, n))
    attn = torch.softmax(corr * temp, dim=-1)
    return matmul(attn, v.reshape(b, n, -1)).reshape(b, hh, ww, -1)


def head(p: Dict[str, torch.Tensor], fq: torch.Tensor, fs: torch.Tensor, v: torch.Tensor,
         temp: float) -> torch.Tensor:
    """The CHM head: halved taps (B, side, side, C) and support values (B,
    2 side, 2 side, Cv) -> the readout (B, 2 side, 2 side, Cv)."""
    return readout(chm4d(p, pool(chm6d(p, correlation6d(p, fq, fs)))), v, temp)


def _quartiles(x: torch.Tensor) -> Tuple[float, float]:
    flat = x.flatten()
    k = flat.numel()
    return (float(flat.kthvalue(max(1, k // 4)).values),
            float(flat.kthvalue(max(1, 3 * k // 4)).values))


@torch.no_grad()
def calibrate(p: Dict[str, torch.Tensor], fq: torch.Tensor,
              fs: torch.Tensor) -> Dict[str, Tuple[float, float]]:
    """Set ``chm6d.bias`` to the negated median of CHM6d's pre-activation on
    the halved taps ``fq``, ``fs``, then ``chm4d.bias`` to that of CHM4d's on
    what follows, so that half of each sigmoid's and softplus's inputs lie
    on either side of 0, as in a trained head. Returns each calibrated
    pre-activation's first and third quartiles."""
    p["chm6d.bias"].zero_()
    p["chm4d.bias"].zero_()
    pre6 = chm6d(p, correlation6d(p, fq, fs))
    p["chm6d.bias"].copy_(-pre6.median())
    pre6 += p["chm6d.bias"]
    pre4 = chm4d(p, pool(pre6))
    p["chm4d.bias"].copy_(-pre4.median())
    pre4 += p["chm4d.bias"]
    return {"chm6d": _quartiles(pre6), "chm4d": _quartiles(pre4)}


def halve(tap: torch.Tensor) -> torch.Tensor:
    """A tap (B, h, h, C) of even side resized to h // 2 (the engine's)."""
    return resize(tap, tap.shape[1] // 2)


@torch.no_grad()
def eval_metrics(p: Dict[str, torch.Tensor], w: torch.Tensor, f_q: torch.Tensor,
                 f_s: torch.Tensor, tap_q: torch.Tensor, tap_s: torch.Tensor,
                 q_label: torch.Tensor, att_wt: float, temp: float) -> Dict[str, torch.Tensor]:
    """The evaluation protocol's per-episode outputs for E one-shot
    episodes, one head call each: adapted classifiers w (E, K, C), bottleneck
    features f_q, f_s (E, h, h, C), stage-4 taps (E, h, h, C'), labels (E,
    H, W). ``pred1`` is the classifier on the readout, ``pred`` on the
    readout blended into the query feature, (readout * att_wt + f_q) / (1 +
    att_wt), ``pred0`` on the query feature; the loss is ``pred``'s
    unweighted cross-entropy."""
    out: Dict[str, List[torch.Tensor]] = {}
    size = q_label.shape[-2:]
    for i in range(w.shape[0]):
        one = slice(i, i + 1)
        wv = head(p, halve(tap_q[one]), halve(tap_s[one]), f_s[one], temp)
        preds = {"1": logits_up(w[one], wv, size),
                 "": logits_up(w[one], (wv * att_wt + f_q[one]) / (1 + att_wt), size),
                 "0": logits_up(w[one], f_q[one], size)}
        for k, logits in preds.items():
            inter, union = iou(logits, q_label[one])
            out.setdefault(f"inter{k}", []).append(inter)
            out.setdefault(f"union{k}", []).append(union)
        ones = torch.ones((1, w.shape[1]), device=w.device)
        out.setdefault("loss", []).append(weighted_ce(preds[""], q_label[one], ones))
    return {k: torch.cat(v) for k, v in out.items()}
