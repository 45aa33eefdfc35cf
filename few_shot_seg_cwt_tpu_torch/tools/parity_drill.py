"""One-command parity pipeline drill: preflight -> record -> replay -> A/B.

The port's counterpart of ``few_shot_seg_cwt_tpu.tools.parity_drill``,
through the port's entry points, on ``--device`` (``cuda`` by default).

Chains the four stages of the real-weights parity workflow so the whole
pipeline is exercised end-to-end as ONE command (each stage was previously
only tested in isolation; the day the released PASCAL/COCO assets land, this
command is the known-good recipe):

1. ``tools.preflight``      — assets present and coherent (hard gate);
2. ``tools.record_episodes``— walk the REFERENCE's seeded val sampler and
   log the episode stream (removes sampling noise from the comparison);
3. ``train.test --opts replay <log>`` — the port's full evaluation
   entry point scoring exactly the recorded stream;
4. ``eval.ab_dtype --replay <log> --pth <stage1>`` — the f32-vs-bf16
   decision run on the same stream and the same imported weights.

Usage:
    python -m few_shot_seg_cwt_tpu_torch.tools.parity_drill \
        --config configs/pascal.yaml --reference <reference tree> \
        --workdir <output dir> --opts train_split 0 shot 1 \
        test_num 1000 n_runs 5

Exit code 0 = every stage green; the final line is a JSON summary with the
per-stage results (replay mIoU, A/B deltas).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> dict:
    from ..config import load_cfg, merge_cfg_from_list

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--reference", required=True,
                    help="root of the reference implementation's tree (holds src/)")
    ap.add_argument("--workdir", required=True,
                    help="directory for the episode log and stage outputs")
    ap.add_argument("--skip-ab", action="store_true",
                    help="stop after the replay eval (skip the dtype A/B)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--opts", nargs=argparse.REMAINDER, default=[])
    a = ap.parse_args(argv)

    os.makedirs(a.workdir, exist_ok=True)
    cfg = load_cfg(a.config)
    if a.opts:
        cfg = merge_cfg_from_list(cfg, a.opts)
    summary: dict = {"config": a.config}

    # 1. preflight (hard gate) ------------------------------------------- #
    from . import preflight

    print("== drill stage 1/4: preflight ==", flush=True)
    rc = preflight.main(["--config", a.config] +
                        (["--opts"] + a.opts if a.opts else []))
    if rc != 0:
        print(json.dumps({**summary, "ok": False, "failed": "preflight"}))
        raise SystemExit(1)
    summary["preflight"] = "ready"

    # 2. record the reference's episode stream --------------------------- #
    from . import record_episodes

    log_path = os.path.join(a.workdir, "episodes.jsonl")
    print("== drill stage 2/4: record reference episode stream ==", flush=True)
    record_episodes.main(["--config", a.config, "--reference", a.reference,
                          "--out", log_path] +
                         (["--opts"] + a.opts if a.opts else []))
    summary["episode_log"] = log_path

    # 3. replay evaluation through the full test entry point ------------- #
    from ..train import test as test_entry

    print("== drill stage 3/4: replay evaluation ==", flush=True)
    replay_cfg = merge_cfg_from_list(cfg.clone(), ["replay", repr(log_path)])
    miou = test_entry.main(replay_cfg, device=a.device)
    summary["replay_miou"] = float(miou)

    # 4. dtype A/B on the same stream and weights ------------------------ #
    if a.skip_ab:
        summary["ab"] = "skipped"
    else:
        from ..eval import ab_dtype
        from .preflight import _stage1_path

        print("== drill stage 4/4: dtype A/B on the replayed stream ==",
              flush=True)
        ab = ab_dtype.main(
            ["--config", a.config, "--replay", log_path,
             "--pth", _stage1_path(cfg),
             "--episodes", str(int(cfg.test_num)),
             "--batch", str(int(cfg.get("episode_batch", 2))),
             "--image-size", str(int(cfg.image_size)),
             "--shot", str(int(cfg.shot)), "--device", a.device] +
            (["--opts"] + a.opts if a.opts else []))
        summary["ab"] = ab

    summary["ok"] = True
    print(json.dumps(summary, default=float))
    return summary


if __name__ == "__main__":
    main()
