"""Real-assets preflight: is this machine ready for the ±0.3 mIoU parity run?

The port's counterpart of ``few_shot_seg_cwt_tpu.tools.preflight``, with the
same checks, lines and exit codes. Checks, in order (each prints
PASS/FAIL/SKIP with details):

1. config — the yaml + --opts load and name an existing data_root;
2. lists — train/val list files exist; a sample of val entries resolves to
   readable image/label pairs with matching shapes (reference load surface:
   src/dataset/utils.py:27-63), read by the port's own decoder
   (``data.imread``: PNG without OpenCV, JPEG through cv2);
3. weights — the stage-1 ``.pth`` resolves per the reference path schema
   (src/train.py:57-59), loads, and loads into the port's PSPNet with
   ``strict=True`` (the config's model, with the depth and classifier width
   of the file: ``utils.convert_ckpt.port_module``);
4. transformer — the stage-2 CWT checkpoint ``<ckpt_used>.pth`` under the
   transformer directory schema loads into the port's transformer with
   ``strict=True`` (src/test.py:61-91 load surface);
5. replay — the episode log parses and its paths resolve (optional).

On success it prints the exact commands for the parity run. Exit code 0 =
ready; 1 = something is absent (each FAIL says what and where).

Usage:
    python -m few_shot_seg_cwt_tpu_torch.tools.preflight --config configs/pascal.yaml \\
        [--opts train_split 0 shot 1 ...] [--replay episodes.jsonl] [--sample 20]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List


class Report:
    def __init__(self):
        self.failures: List[str] = []

    def ok(self, what: str, detail: str = "") -> None:
        print(f"  PASS  {what}" + (f" — {detail}" if detail else ""))

    def fail(self, what: str, detail: str) -> None:
        print(f"  FAIL  {what} — {detail}")
        self.failures.append(f"{what}: {detail}")

    def skip(self, what: str, detail: str) -> None:
        print(f"  SKIP  {what} — {detail}")


def check_lists(cfg, rep: Report, sample: int) -> None:
    from ..data.imread import read

    for name in ("train_list", "val_list"):
        path = cfg[name]
        if not os.path.isfile(path):
            rep.fail(name, f"list file not found: {path}")
            return
        rep.ok(name, path)

    lines = [ln.split() for ln in open(cfg.val_list) if ln.strip()]
    if not lines:
        rep.fail("val_list", "empty list file")
        return
    malformed = [i for i, p in enumerate(lines) if len(p) < 2]
    if malformed:
        rep.fail("val_list format",
                 f"{len(malformed)} line(s) lack 'image label' columns; "
                 f"first at line {malformed[0] + 1}")
        return
    step = max(1, len(lines) // max(sample, 1))
    bad: List[str] = []
    checked = 0
    for parts in lines[::step][:sample]:
        img_p = os.path.join(cfg.data_root, parts[0])
        lab_p = os.path.join(cfg.data_root, parts[1])
        if not os.path.isfile(img_p):
            bad.append(f"missing image {img_p}")
            continue
        if not os.path.isfile(lab_p):
            bad.append(f"missing label {lab_p}")
            continue
        try:
            img = read(img_p)
            lab = read(lab_p, gray=True)
        except (ValueError, ImportError, OSError) as e:
            bad.append(f"unreadable pair {parts[0]}: {e}")
        else:
            if img.shape[:2] != lab.shape[:2]:
                bad.append(f"shape mismatch {parts[0]}: {img.shape[:2]} vs {lab.shape[:2]}")
        checked += 1
    if bad:
        rep.fail("data_root coherence",
                 f"{len(bad)}/{checked or len(bad)} sampled pairs broken; first: {bad[0]}")
    else:
        rep.ok("data_root coherence", f"{checked} sampled image/label pairs readable")


def _stage1_path(cfg) -> str:
    if cfg.resume_weights and os.path.isfile(str(cfg.resume_weights)):
        return str(cfg.resume_weights)
    from ..train.common import stage1_weights_path

    return stage1_weights_path(cfg)


def check_stage1(cfg, rep: Report) -> None:
    from ..utils.convert import load_torch_checkpoint
    from ..utils.convert_ckpt import port_module

    path = _stage1_path(cfg)
    if not os.path.isfile(path):
        rep.fail("stage-1 weights", f"no .pth at {path} (reference schema "
                 "src/train.py:57-59; set --opts resume_weights <dir-or-file>)")
        return
    try:
        sd = load_torch_checkpoint(path)
    except Exception as e:  # corrupt/wrong-format file
        rep.fail("stage-1 weights", f"{path} failed to load: {e}")
        return
    rep.ok("stage-1 .pth", f"{path} ({len(sd)} tensors)")
    try:
        port_module("pspnet", sd, cfg)
    except (RuntimeError, KeyError, ValueError) as e:
        rep.fail("weight coverage", f"the port's PSPNet does not load it strictly: "
                 f"{str(e).splitlines()[0]}")
        return
    rep.ok("weight coverage", f"{len(sd)} tensors load into the port's "
           f"{cfg.arch} PSPNet (strict)")


def check_transformer(cfg, rep: Report) -> None:
    from ..train.common import trans_ckpt_dir
    from ..utils.convert import load_torch_checkpoint
    from ..utils.convert_ckpt import port_module

    root = trans_ckpt_dir(cfg)
    path = os.path.join(root, f"{cfg.ckpt_used}.pth")
    if not os.path.exists(path):
        rep.fail("CWT weights",
                 f"no {cfg.ckpt_used}.pth under {root} "
                 "(eval would score a random-init transformer)")
        return
    try:
        port_module("cwt", load_torch_checkpoint(path), cfg)
    except Exception as e:  # a wrong file, or keys that do not fit
        rep.fail("CWT .pth", f"{path}: {str(e).splitlines()[0]}")
        return
    rep.ok("CWT weights", path)


def check_replay(cfg, rep: Report, replay: str) -> None:
    if not replay:
        rep.skip("replay log", "none given — eval will sample episodes "
                 "(record one with tools/record_episodes for a noise-free comparison)")
        return
    if not os.path.isfile(replay):
        rep.fail("replay log", f"not found: {replay}")
        return
    from ..data.replay import load_episode_log

    try:
        eps = load_episode_log(replay)
    except Exception as e:
        rep.fail("replay log", f"{replay} failed to parse: {e}")
        return
    want = cfg.n_runs * cfg.test_num
    first = eps[0]
    q0 = first["q"][0]
    probe = q0 if os.path.isabs(q0) else os.path.join(cfg.data_root, q0)
    if not os.path.isfile(probe):
        rep.fail("replay paths", f"first query {probe} not found")
    elif len(eps) < want:
        rep.fail("replay length",
                 f"{len(eps)} episodes < n_runs*test_num = {want}")
    else:
        rep.ok("replay log", f"{len(eps)} episodes, paths resolve")


def main(argv=None) -> int:
    from ..config import load_cfg, merge_cfg_from_list

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--replay", default=None)
    ap.add_argument("--sample", type=int, default=20)
    ap.add_argument("--opts", nargs=argparse.REMAINDER, default=[])
    a = ap.parse_args(argv)

    cfg = load_cfg(a.config)
    if a.opts:
        cfg = merge_cfg_from_list(cfg, a.opts)

    rep = Report()
    print(f"preflight: {a.config} (split {cfg.train_split}, shot {cfg.shot}, "
          f"{cfg.arch}{cfg.layers})")

    if os.path.isdir(cfg.data_root):
        rep.ok("data_root", cfg.data_root)
        check_lists(cfg, rep, a.sample)
    else:
        rep.fail("data_root", f"directory not found: {cfg.data_root}")
    check_stage1(cfg, rep)
    check_transformer(cfg, rep)
    check_replay(cfg, rep, a.replay)

    if rep.failures:
        print(f"\nNOT READY — {len(rep.failures)} issue(s):")
        for f in rep.failures:
            print(f"  * {f}")
        return 1

    replay_opt = f" replay {a.replay}" if a.replay else ""
    print("\nREADY. Parity commands:")
    print(f"  python -m few_shot_seg_cwt_tpu_torch.train.test --config {a.config} \\")
    print(f"      --opts train_split {cfg.train_split} shot {cfg.shot} "
          f"cls_lr 0.1 test_num {cfg.test_num} n_runs {cfg.n_runs}{replay_opt}")
    print(f"  python -m few_shot_seg_cwt_tpu_torch.eval.ab_dtype --config {a.config} "
          f"--pth {_stage1_path(cfg)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
