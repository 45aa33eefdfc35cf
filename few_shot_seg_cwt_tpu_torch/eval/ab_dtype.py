"""fp32 vs bf16 A/B: identical weights and episodes through both engines.

Counterpart of ``few_shot_seg_cwt_tpu.eval.ab_dtype``. The bf16 backbone
(``compute_dtype bfloat16`` / the reference's ``use_amp`` knob, reference:
src/train_kshot.py:146-190) changes the masks a user gets; this harness
measures by how much. It runs the SAME weights, the SAME synthetic episodes
and the SAME classifier inits through an fp32 ``EpisodicEngine`` and a bf16
one (the whole-backbone cast, or with ``--stages`` the mixed per-stage
policy, ``bf16_stages``) and reports

  * protocol mIoU for both (per-class FG I/U accumulation, src/test.py:225-243)
    and the delta in points, for the CWT prediction and the raw classifier,
  * the share of feature-resolution mask pixels on which the two argmax
    predictions agree (and its complement, the JAX harness's flip rate).

Weights default to the seeded random init; ``--pth`` (stage-1 PSPNet .pth)
and ``--trans-pth`` (CWT .pth) run it on real weights. ``--replay`` runs the
A/B on a recorded episode log (real images under ``data_root``) instead of
synthetic episodes, through the episode loader.

Usage::

    python -m few_shot_seg_cwt_tpu_torch.eval.ab_dtype [--episodes 128]
        [--batch 16] [--image-size 473] [--shot 1] [--stages stem,layer1]
        [--pth stage1.pth] [--trans-pth best.pth] [--replay episodes.jsonl]
        [--device cuda]

Prints one JSON line with the measurements and the device they ran on.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from collections import defaultdict
from typing import Dict, Optional

import torch

from ..data.loader import EpisodeLoader
from ..data.replay import ReplayEpisodicDataset
from ..data.synthetic import make_episode_batch
from ..episodic.engine import EpisodicEngine
from ..train.common import fp32_parity, init_backbone, init_cwt, load_backbone_weights
from ..utils.convert import load_torch_checkpoint
from .validate import accumulate_fg_iou, batch_generator, fg_miou


def run_ab(cfg, n_episodes: int, e_batch: int, pth: Optional[str] = None,
           trans_pth: Optional[str] = None, stages: Optional[str] = None,
           device="cuda", log=print) -> Dict:
    """A/B fp32 vs bf16 on ``device``. ``stages`` switches the B side from the
    whole-backbone bf16 cast to the mixed per-stage policy."""
    cfg32 = cfg.clone()
    cfg32.update(compute_dtype="float32", use_amp=False, bf16_stages=None)
    cfg_bf = cfg32.clone()
    if stages:
        cfg_bf.bf16_stages = stages
    else:
        cfg_bf.compute_dtype = "bfloat16"

    backbone = init_backbone(cfg32, log=log)
    if pth:
        load_backbone_weights(backbone, pth, skip_gamma=False)
        log(f"=> A/B on imported stage-1 weights '{pth}'")
    cwt = init_cwt(cfg32)
    if trans_pth:
        cwt.load_state_dict(load_torch_checkpoint(trans_pth))
        log(f"=> A/B on imported CWT weights '{trans_pth}'")
    # the bf16 engine casts its own copy of the fp32 backbone; one CWT
    engine_bf = EpisodicEngine(cfg_bf, backbone=copy.deepcopy(backbone), cwt=cwt,
                               device=device)
    engine32 = EpisodicEngine(cfg32, backbone=backbone, cwt=cwt, device=device)

    # --replay: a recorded episode stream (real images) in place of synthetic
    # episodes, the decision-grade comparison
    replay_batches = None
    if cfg.get("replay"):
        ds = ReplayEpisodicDataset(cfg, str(cfg.replay))
        e_batch = min(e_batch, len(ds))  # logs smaller than one batch still run
        replay_batches = iter(EpisodeLoader(ds, batch_size=e_batch, shuffle=False,
                                            num_workers=cfg.workers, device=device))
        n_episodes = min(n_episodes, len(ds))

    n_batches = max(1, n_episodes // e_batch)
    seed = int(cfg.manual_seed or 0)
    acc = {name: (defaultdict(float), defaultdict(float))
           for name in ("fp32", "bf16", "fp32_raw", "bf16_raw")}
    agree = pixels = 0
    for b in range(n_batches):
        episodes = (next(replay_batches) if replay_batches is not None else
                    make_episode_batch(seed=b + 1, e=e_batch, size=cfg.image_size,
                                       shot=cfg.shot))
        w0 = engine32.init_weights(e_batch, batch_generator(seed, 0, b))
        m32 = {k: v.cpu().numpy() for k, v in
               engine32.eval_metrics_batch_pred(episodes, w0=w0).items()}
        mbf = {k: v.cpu().numpy() for k, v in
               engine_bf.eval_metrics_batch_pred(episodes, w0=w0).items()}
        accumulate_fg_iou(*acc["fp32"], m32)
        accumulate_fg_iou(*acc["bf16"], mbf)
        accumulate_fg_iou(*acc["fp32_raw"], m32, suffix="0")
        accumulate_fg_iou(*acc["bf16_raw"], mbf, suffix="0")
        agree += int((m32["pred_lab"] == mbf["pred_lab"]).sum())
        pixels += m32["pred_lab"].size
        log(f"A/B batch {b + 1}/{n_batches}: mIoU fp32 {fg_miou(*acc['fp32']):.4f} "
            f"bf16 {fg_miou(*acc['bf16']):.4f}")

    miou32, mioubf = fg_miou(*acc["fp32"]), fg_miou(*acc["bf16"])
    dev = torch.device(device)
    return {
        "episodes": n_batches * e_batch,
        "miou_fp32": miou32,
        "miou_bf16": mioubf,
        "delta_pts": (mioubf - miou32) * 100,
        "miou_raw_fp32": fg_miou(*acc["fp32_raw"]),
        "miou_raw_bf16": fg_miou(*acc["bf16_raw"]),
        "mask_agreement": agree / max(pixels, 1),
        "argmax_flip_rate": 1 - agree / max(pixels, 1),
        "weights": "imported .pth" if pth else "random init",
        "shot": cfg.shot,
        "image_size": cfg.image_size,
        "bf16_stages": stages or "all (whole-backbone cast)",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
    }


def main(argv=None) -> Dict:
    from ..config import default_cfg, load_cfg, merge_cfg_from_list
    from ..models.pspnet import BACKBONE_STAGES

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default=None,
                    help="experiment yaml; defaults to the built-in defaults table")
    ap.add_argument("--opts", nargs="*", default=[],
                    help="config overrides: key value key value ...")
    ap.add_argument("--episodes", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--image-size", type=int, default=473)
    ap.add_argument("--shot", type=int, default=1)
    ap.add_argument("--pth", default=None, help="stage-1 PSPNet .pth")
    ap.add_argument("--trans-pth", default=None, help="CWT transformer .pth")
    ap.add_argument("--replay", default=None,
                    help="recorded episode log: run the A/B on real images instead of "
                         "synthetic episodes")
    ap.add_argument("--stages", default=None,
                    help="comma list of backbone stages to run in bf16 (mixed policy) "
                         "instead of the whole-backbone cast")
    ap.add_argument("--sweep", action="store_true",
                    help="one A/B per backbone stage in bf16 alone, one JSON line each")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ns = ap.parse_args(argv)

    cfg = load_cfg(ns.config) if ns.config else default_cfg()
    if ns.opts:
        cfg = merge_cfg_from_list(cfg, ns.opts)
    cfg.image_size, cfg.shot, cfg.replay = ns.image_size, ns.shot, ns.replay
    fp32_parity()
    err = lambda *a: print(*a, file=sys.stderr)  # noqa: E731
    runs = {s: s for s in BACKBONE_STAGES} if ns.sweep else {None: ns.stages}
    results = {}
    for key, stages in runs.items():
        results[key] = run_ab(cfg, ns.episodes, ns.batch, pth=ns.pth, trans_pth=ns.trans_pth,
                              stages=stages, device=ns.device, log=err)
        print(json.dumps(results[key]))
    return results if ns.sweep else results[None]


if __name__ == "__main__":
    main()
