"""Record the reference's seeded episode stream for replay-based parity runs.

The port's own copy of ``few_shot_seg_cwt_tpu.tools.record_episodes``.
Walks the REFERENCE implementation's episodic val sampler (torch; reference:
src/dataset/dataset.py:180-328) with the reference's exact seeding
(src/test.py:44-51) and writes a JSONL episode log — query path pair, chosen
class id, support path pairs (``write_log``) — that the port's
`data.replay.ReplayEpisodicDataset` replays verbatim through its evaluation
(and the JAX package's through its own). With both frameworks scoring
the identical episode composition, the ±0.3-pt parity comparison measures
framework delta only, not sampling noise.

Usage (needs the reference tree + the real dataset on disk):

    python -m few_shot_seg_cwt_tpu_torch.tools.record_episodes \
        --config configs/pascal.yaml --reference <reference tree> \
        --out episodes_split0_1shot.jsonl \
        [--opts train_split 0 shot 1 test_num 1000 n_runs 5]

Determinism contract: the stream equals the reference's `python -m src.test`
episode order when the reference runs with workers=0 (worker processes
consume RNG in scheduling-dependent order; the published protocol is
single-stream). The log is one continuous walk of n_runs x test_num
episodes — the reference's loader iterator persists across runs
(src/test.py:150-153 re-creates it only on exhaustion).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List


def _install_reference(ref_root: str) -> None:
    """Put the reference on sys.path with the shims its imports need."""
    assert os.path.isdir(os.path.join(ref_root, "src")), (
        f"{ref_root} does not look like the reference tree"
    )
    if ref_root not in sys.path:
        sys.path.insert(0, ref_root)
    # torchvision is only imported, never exercised, by the modules we need
    if "torchvision" not in sys.modules:
        import types

        tv = types.ModuleType("torchvision")
        tv.models = types.ModuleType("torchvision.models")
        tv.transforms = types.ModuleType("torchvision.transforms")
        tv.transforms.functional = types.ModuleType(
            "torchvision.transforms.functional")
        tv.transforms.ColorJitter = object
        tv.transforms.ToTensor = object
        sys.modules["torchvision"] = tv
        sys.modules["torchvision.models"] = tv.models
        sys.modules["torchvision.transforms"] = tv.transforms
        sys.modules["torchvision.transforms.functional"] = (
            tv.transforms.functional)
    # py3.12: collections.Iterable moved; the reference transform uses it
    import collections
    import collections.abc

    if not hasattr(collections, "Iterable"):
        collections.Iterable = collections.abc.Iterable


def _relpath(path: str, data_root: str) -> str:
    root = os.path.abspath(data_root)
    ap = os.path.abspath(path)
    if ap.startswith(root + os.sep):
        return os.path.relpath(ap, root)
    return path


def record(cfg, ref_root: str, n_episodes: int) -> List[dict]:
    """Walk the reference's seeded val sampler; return episode dicts."""
    _install_reference(ref_root)

    import random

    import numpy as np
    import torch

    from src.dataset import transform as ref_transform
    from src.dataset.classes import filter_classes, get_split_classes
    from src.dataset.dataset import EpisodicData

    # the reference's full seed set (src/test.py:44-51); cudnn knobs are
    # GPU-only and do not affect sampling
    seed = cfg.manual_seed
    if seed is not None:
        np.random.seed(seed)
        torch.manual_seed(seed)
        random.seed(seed)

    # val transform exactly as get_val_loader builds it (dataset.py:78-84);
    # the transform consumes no RNG but keeps __getitem__ unmodified
    val_trans = [ref_transform.ToTensor(),
                 ref_transform.Normalize(mean=cfg.mean, std=cfg.std)]
    if "resize_np" in cfg.augmentations:
        val_trans = [ref_transform.Resize_np(
            size=(cfg.image_size, cfg.image_size))] + val_trans
    else:
        padding = ([v * 255 for v in cfg.mean]
                   if cfg.get("padding") == "avg" else None)
        val_trans = [ref_transform.Resize(
            cfg.image_size, padding=padding)] + val_trans
    val_transform = ref_transform.Compose(val_trans)

    split_classes = get_split_classes(cfg)
    if cfg.test_name == "default":
        test_name, test_split = cfg.train_name, cfg.train_split
    else:
        test_name, test_split = cfg.test_name, cfg.test_split
    class_list = filter_classes(
        cfg.train_name, cfg.train_split, test_name, test_split, split_classes
    )

    dataset = EpisodicData(
        mode_train=False, dt_transform=val_transform,
        class_list=class_list, args=cfg,
    )
    # img path -> label path, for the support pairs (the sampler reports
    # image paths only, spprt_oris[0])
    img2lab = {img: lab for img, lab in dataset.data_list}
    for files in dataset.sub_class_file_list.values():
        img2lab.update({img: lab for img, lab in files})

    episodes = []
    n = len(dataset)
    for e in range(n_episodes):
        # batch-1, shuffle=False, workers=0 walk with wrap-around — the
        # reference's persistent iterator re-walks in order on exhaustion
        out = dataset[e % n]
        _, _, _, _, subcls_list, spprt_oris, qry_oris = out
        class_chosen = class_list[subcls_list[0] - 1]
        q_img_path = qry_oris[0]
        sup_img_paths = spprt_oris[0]
        episodes.append({
            "q": [_relpath(q_img_path, cfg.data_root),
                  _relpath(img2lab[q_img_path], cfg.data_root)],
            "cls": int(class_chosen),
            "s": [[_relpath(p, cfg.data_root),
                   _relpath(img2lab[p], cfg.data_root)]
                  for p in sup_img_paths],
        })
        if (e + 1) % 200 == 0:
            print(f"recorded {e + 1}/{n_episodes} episodes")
    return episodes


def write_log(path: str, episodes: List[dict]) -> None:
    """One JSON object an episode, one episode a line: the log that
    ``data.replay.load_episode_log`` reads."""
    with open(path, "w") as f:
        for ep in episodes:
            f.write(json.dumps(ep) + "\n")


def main(argv=None) -> str:
    from ..config import load_cfg, merge_cfg_from_list

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--reference", required=True,
                    help="root of the reference implementation's tree (holds src/)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--opts", nargs=argparse.REMAINDER, default=[])
    a = ap.parse_args(argv)

    cfg = load_cfg(a.config)
    if a.opts:
        cfg = merge_cfg_from_list(cfg, a.opts)

    n_episodes = cfg.n_runs * cfg.test_num
    episodes = record(cfg, a.reference, n_episodes)
    write_log(a.out, episodes)
    print(f"wrote {len(episodes)} episodes to {a.out} "
          f"(seed {cfg.manual_seed}, split {cfg.train_split}, "
          f"shot {cfg.shot})")
    return a.out


if __name__ == "__main__":
    main()
