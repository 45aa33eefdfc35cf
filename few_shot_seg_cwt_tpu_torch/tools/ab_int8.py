"""int8-consensus accuracy A/B: the same weights and episodes, quantized or not.

Counterpart of the repository root's ``tools/ab_int8.py``. The int8
consensus modes (``ops/quant.py``, ``FSS_NCONS_INT8=fake|dot``) change the
masks a user gets; this harness measures by how much. It runs the SAME
head weights, the SAME synthetic episode stream
(``make_episode_batch(seed=100 + i, ...)``) and the SAME classifier inits
through a head engine with the flag off and a fresh engine (copies of the
same weights) with it on, and reports

  * binary FG mIoU of both engines' label-free serving masks against the
    episode labels (255 ignored), and the delta in points;
  * the argmax flip rate between the two masks (at the image size).

Under the flag a centre-pivot consensus runs the rank-4 route, whose plane
convs are the ones quantized (as in JAX); without it, the pivot kernels. Model
settings: the MMN ones of configs/pascal_mmn.yaml (``conv4d red``, ``temp
20``, ``att_wt 0.2``, ``rmid l34``, ``wa``, dropouts 0.5), as the JAX tool
sets them. Weights: the seeded random init, or a stage-1 PSPNet ``--pth``
for the backbone; ``--replay`` runs a recorded episode log instead of
synthetic episodes.

Usage::

    python -m few_shot_seg_cwt_tpu_torch.tools.ab_int8 [--mode fake|dot]
        [--head mmn] [--episodes 8] [--batch 4] [--image-size 473] [--shot 1]
        [--use-amp] [--replay episodes.jsonl] [--pth stage1.pth]
        [--device cuda]

Prints one JSON line with the JAX tool's keys (unrounded).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

MMN_KNOBS = dict(conv4d="red", temp=20.0, att_wt=0.2, rmid="l34", wa=True, proj_drop=0.5,
                 att_drop=0.5)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="int8 consensus accuracy A/B")
    ap.add_argument("--mode", default="fake", choices=["fake", "dot"])
    ap.add_argument("--head", default="mmn")
    ap.add_argument("--episodes", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--image-size", type=int, default=473)
    ap.add_argument("--shot", type=int, default=1)
    ap.add_argument("--use-amp", action="store_true")
    ap.add_argument("--replay", default=None,
                    help="episode-log jsonl (data/replay.py): the A/B on a recorded stream")
    ap.add_argument("--pth", default=None, help="stage-1 PSPNet .pth for the backbone")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def fg_iou(masks: np.ndarray, labels: np.ndarray) -> float:
    """Binary FG IoU per episode, averaged (255 ignored)."""
    ious = []
    for m, t in zip(masks, labels):
        valid = t != 255
        inter = ((m == 1) & (t == 1) & valid).sum()
        union = (((m == 1) | (t == 1)) & valid).sum()
        ious.append(inter / max(union, 1))
    return float(np.mean(ious))


def config(args: argparse.Namespace):
    from ..config import default_cfg

    cfg = default_cfg()
    cfg.image_size, cfg.shot, cfg.use_amp = args.image_size, args.shot, args.use_amp
    for k, v in MMN_KNOBS.items():
        cfg[k] = v
    return cfg


def run(args: argparse.Namespace, backbone=None, head=None) -> Dict:
    """The A/B; ``backbone`` and ``head`` (fp32 modules, left as they are)
    replace the seeded random weights."""
    from ..data.synthetic import make_episode_batch
    from ..episodic.heads import HeadEngine, build_head
    from ..models.pspnet import build_pspnet
    from ..train.common import fp32_parity, load_backbone_weights

    fp32_parity()
    cfg = config(args)
    if backbone is None:
        backbone = build_pspnet(_fp32(cfg))
        if args.pth:
            load_backbone_weights(backbone, args.pth, skip_gamma=False)
    if head is None:
        head = build_head(cfg, args.head)

    batches = []
    if args.replay:
        from ..data.loader import EpisodeLoader
        from ..data.replay import ReplayEpisodicDataset

        ds = ReplayEpisodicDataset(cfg, args.replay)
        args.batch = min(args.batch, len(ds))
        args.episodes = min(args.episodes, len(ds))
        loader = EpisodeLoader(ds, batch_size=args.batch, shuffle=False, num_workers=0,
                               drop_last=True, device="cpu")
        batches = [{k: v.numpy() for k, v in b.items()} for b in loader]
    e = args.batch

    def stream(i, bi):
        if batches:
            return batches[bi % len(batches)]
        return make_episode_batch(seed=100 + i, e=e, size=args.image_size, shot=args.shot)

    def masks_of(engine):
        masks, labels = [], []
        for bi, i in enumerate(range(0, args.episodes, e)):
            host = stream(i, bi)
            w0 = engine.init_weights(e, torch.Generator().manual_seed(7 + i))
            episodes = {k: host[k] for k in ("s_img", "s_label", "q_img", "cls")}
            masks.append(engine.serve_batch(episodes, w0=w0).cpu().numpy())
            labels.append(np.asarray(host["q_label"]))
        return np.concatenate(masks), np.concatenate(labels)

    saved = os.environ.pop("FSS_NCONS_INT8", None)
    try:
        engine_a = HeadEngine(cfg, args.head, backbone=copy.deepcopy(backbone),
                              head=copy.deepcopy(head), device=args.device)
        masks_a, labels = masks_of(engine_a)
        del engine_a
        os.environ["FSS_NCONS_INT8"] = args.mode
        engine_b = HeadEngine(cfg, args.head, backbone=copy.deepcopy(backbone),
                              head=copy.deepcopy(head), device=args.device)
        masks_b, _ = masks_of(engine_b)
    finally:
        os.environ.pop("FSS_NCONS_INT8", None)
        if saved is not None:
            os.environ["FSS_NCONS_INT8"] = saved
    miou_a, miou_b = fg_iou(masks_a, labels), fg_iou(masks_b, labels)
    return {
        "mode": args.mode,
        "head": args.head,
        "episodes": int(args.episodes),
        "image_size": int(args.image_size),
        "use_amp": bool(args.use_amp),
        "miou_base": miou_a,
        "miou_int8": miou_b,
        "delta_pts": (miou_b - miou_a) * 100,
        "argmax_flip_rate": float((masks_a != masks_b).mean()),
        "device": str(args.device),
    }


def _fp32(cfg):
    out = cfg.clone()
    out.use_amp, out.compute_dtype = False, "float32"
    return out


def main(argv=None, backbone=None, head=None) -> Optional[Dict]:
    out = run(parse(argv), backbone, head)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
