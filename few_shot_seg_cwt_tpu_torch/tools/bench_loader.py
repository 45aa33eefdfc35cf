"""Host input-pipeline benchmark: can the loader feed the card?

The port's counterpart of ``few_shot_seg_cwt_tpu.tools.bench_loader``, on
the port's ``EpisodeLoader`` (sampler, PNG decode in Python + the host C++
core's unfilter or cv2 for JPEG, transforms with the C++ fused resize +
normalize tail, decode threads, collation, and with ``--device cuda`` the
pinned ring and the copy to the card). Each 1-shot 473 px episode is
7.16 MB of decoded and transformed tensors (``mb_per_episode``); the card
evaluates ~47 fp32 and ~150 bf16 CWT episodes/s (``PERF.md``), the rate
``--device-rate`` compares against.

This tool fabricates an on-disk image tree (JPEG images, PNG masks, with
cv2, as the JAX package's does) or reads ``--data-root``/``--list``, then
measures episodes/s end to end and prints one JSON line with the JAX
tool's keys. ``--sweep`` measures workers 1/2/4/8 in one subprocess each;
the port has no pure-Python transform tail to compare (the C++ core is
part of its data path), so the sweep's ``curve_python`` is empty.

Usage:
    python -m few_shot_seg_cwt_tpu_torch.tools.bench_loader [--episodes 256]
        [--workers N] [--image-size 473] [--shot 1] [--device cuda]
        [--data-root DIR --list FILE]   # real data instead of synthetic
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np


def fabricate_tree(root: str, n_images: int, side: int = 500) -> str:
    """PASCAL-layout jpg/png tree with >=2*32*32-px masks; returns list path."""
    import cv2

    os.makedirs(os.path.join(root, "img"), exist_ok=True)
    os.makedirs(os.path.join(root, "lab"), exist_ok=True)
    rng = np.random.default_rng(0)
    lines = []
    for i in range(n_images):
        h = side + int(rng.integers(-60, 60))
        w = side + int(rng.integers(-60, 60))
        img = rng.integers(0, 255, size=(h, w, 3)).astype(np.uint8)
        lab = np.zeros((h, w), np.uint8)
        cls = 1 + i % 2
        lab[h // 8: 7 * h // 8, w // 8: 7 * w // 8] = cls
        cv2.imwrite(os.path.join(root, "img", f"{i}.jpg"), img)
        cv2.imwrite(os.path.join(root, "lab", f"{i}.png"), lab)
        lines.append(f"img/{i}.jpg lab/{i}.png\n")
    lst = os.path.join(root, "list.txt")
    with open(lst, "w") as f:
        f.writelines(lines)
    return lst


def _sweep(ns):
    """workers grid, one subprocess per point; prints each point's JSON line
    plus a final summary row."""
    import subprocess

    points = []
    for workers in (1, 2, 4, 8):
        cmd = [sys.executable, "-m", __spec__.name,
               "--episodes", str(ns.episodes), "--batch", str(ns.batch),
               "--workers", str(workers),
               "--image-size", str(ns.image_size), "--shot", str(ns.shot),
               "--images", str(ns.images), "--device", ns.device,
               "--device-rate", str(ns.device_rate)]
        if ns.data_root and ns.list_file:
            cmd += ["--data-root", ns.data_root, "--list", ns.list_file]
        out = subprocess.run(cmd, capture_output=True, text=True, check=True)
        line = [ln for ln in out.stdout.splitlines() if ln.startswith("{")][-1]
        r = json.loads(line)
        r["workers"] = workers
        r["native"] = True
        points.append(r)
        print(json.dumps(r), flush=True)
    best = max(points, key=lambda r: r["value"])
    print(json.dumps({
        "metric": f"host loader worker-scaling sweep ({ns.shot}-shot "
                  f"@{ns.image_size}px, host cpus={os.cpu_count()})",
        "best_eps_per_sec": best["value"],
        "best_workers": best["workers"],
        "best_native": best["native"],
        "chips_fed_at_device_rate": best["chips_fed_at_device_rate"],
        "curve_native": {str(r["workers"]): r["value"] for r in points},
        "curve_python": {},
    }))
    return points


def main(argv=None):
    from ..config import default_cfg
    from ..data.episodic import EpisodicDataset
    from ..data.loader import EpisodeLoader

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--episodes", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 2)
    ap.add_argument("--image-size", type=int, default=473)
    ap.add_argument("--shot", type=int, default=1)
    ap.add_argument("--images", type=int, default=48,
                    help="synthetic tree size (images)")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--list", dest="list_file", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where batches are delivered: cuda (pinned ring) or cpu")
    ap.add_argument("--device-rate", type=float, default=100.0,
                    help="device episodes/sec/chip to compare against")
    ap.add_argument("--sweep", action="store_true",
                    help="measure a workers -> eps/s curve (1/2/4/8), one "
                         "subprocess per point (clean thread pools)")
    ns = ap.parse_args(argv)

    if ns.sweep:
        return _sweep(ns)

    cfg = default_cfg()
    cfg.image_size = ns.image_size
    cfg.shot = ns.shot
    cfg.workers = ns.workers
    cfg.scan_cache = None
    cfg.train_split = 3  # classes 1/2 are train classes of fold 3

    tmp = None
    if ns.data_root and ns.list_file:
        cfg.data_root, cfg.train_list = ns.data_root, ns.list_file
    else:
        tmp = tempfile.TemporaryDirectory(prefix="fss_loader_bench_")
        print(f"fabricating {ns.images}-image tree under {tmp.name} ...",
              file=sys.stderr)
        cfg.train_list = fabricate_tree(tmp.name, ns.images)
        cfg.data_root = tmp.name

    ds = EpisodicDataset(cfg, train=True)
    loader = EpisodeLoader(ds, batch_size=ns.batch, shuffle=True,
                           num_workers=ns.workers, device=ns.device)

    # warm-up batch (thread pool spin-up, the C++ core's build and load)
    it = iter(loader)
    next(it)

    n_batches = max(1, ns.episodes // ns.batch)
    times = []
    done = 0
    t_total0 = time.time()
    while done < n_batches:
        t0 = time.time()
        try:
            next(it)
        except StopIteration:
            it = iter(loader)
            continue
        times.append(time.time() - t0)
        done += 1
    wall = time.time() - t_total0
    it.close()   # stops the loader's prefetching before the tree goes

    eps = n_batches * ns.batch
    rate = eps / wall
    per_batch = np.asarray(times)
    result = {
        "metric": f"host loader episodes/sec ({ns.shot}-shot @{ns.image_size}px, "
                  f"{ns.workers} workers, native=yes, device={ns.device})",
        "value": round(rate, 2),
        "unit": "episodes/sec",
        "p50_batch_s": round(float(np.median(per_batch)), 4),
        "episodes": eps,
        "chips_fed_at_device_rate": round(rate / ns.device_rate, 2),
        "mb_per_episode": round(
            (ns.shot + 1) * (ns.image_size ** 2) * 3 * 4 / 1e6
            + (ns.shot + 1) * (ns.image_size ** 2) * 4 / 1e6, 2),
    }
    print(json.dumps(result))
    if tmp is not None:
        tmp.cleanup()
    return result


if __name__ == "__main__":
    main()
