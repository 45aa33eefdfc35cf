"""Dataset list parsing and per-class image indexing.

The port's own copy of ``few_shot_seg_cwt_tpu.data.listing`` (reference:
src/dataset/utils.py:27-118): each list line is ``rel/image.jpg
rel/label.png``; an image is kept for a class only if that class covers at
least 2*32*32 pixels of its mask. Masks decode through ``data.imread`` (gray
PNG without OpenCV). The scan runs on a thread pool, not a process pool: a
process that holds a CUDA context must not fork. It is cached to disk under a
key of (data root, list file, its mtime and size, class list, "torch"), so
the two packages never share a scan.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import imread

MIN_PIXELS = 2 * 32 * 32


def process_line(
    line: str, data_root: str, class_list: Sequence[int]
) -> Tuple[List[Tuple[str, str]], Dict[int, List[Tuple[str, str]]]]:
    parts = line.strip().split(" ")
    image_path = os.path.join(data_root, parts[0])
    label_path = os.path.join(data_root, parts[1])
    item = (image_path, label_path)
    if not os.path.isfile(label_path):  # cv2.imread's None: skip the line
        return [], {}
    label = imread.read(label_path, gray=True)
    present = [c for c in np.unique(label).tolist() if c not in (0, 255)]

    kept = [
        c for c in present
        if c in class_list and int((label == c).sum()) >= MIN_PIXELS
    ]
    items: List[Tuple[str, str]] = []
    by_class: Dict[int, List[Tuple[str, str]]] = defaultdict(list)
    if kept:
        items.append(item)
        for c in kept:
            by_class[c].append(item)
    return items, by_class


def _cache_key(data_root: str, data_list: str, class_list: Sequence[int]) -> str:
    st = os.stat(data_list)
    # data_root is part of the key: the cached items hold absolute paths
    # built from it, so a different root must never reuse an old scan
    blob = json.dumps([os.path.abspath(data_root), data_list,
                       st.st_mtime, st.st_size, sorted(class_list), "torch"])
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def make_dataset(
    data_root: str,
    data_list: str,
    class_list: Sequence[int],
    num_workers: int = 0,
    cache_dir: str | None = None,
) -> Tuple[List[Tuple[str, str]], Dict[int, List[Tuple[str, str]]]]:
    """Scan a list file; returns (image_label_list, class -> items dict)."""
    if not os.path.isfile(data_list):
        raise RuntimeError(f"Image list file does not exist: {data_list}")

    if cache_dir:
        cache_path = os.path.join(cache_dir, f"scan_{_cache_key(data_root, data_list, class_list)}.pkl")
        if os.path.isfile(cache_path):
            with open(cache_path, "rb") as f:
                return pickle.load(f)

    with open(data_list) as f:
        lines = f.readlines()

    fn = partial(process_line, data_root=data_root, class_list=list(class_list))
    if num_workers and num_workers > 1:
        with ThreadPoolExecutor(num_workers) as pool:
            results = list(pool.map(fn, lines))
    else:
        results = [fn(line) for line in lines]

    image_label_list: List[Tuple[str, str]] = []
    class_file_dict: Dict[int, List[Tuple[str, str]]] = defaultdict(list)
    for items, by_class in results:
        image_label_list += items
        for k, v in by_class.items():
            class_file_dict[k] += v

    out = (image_label_list, dict(class_file_dict))
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{cache_path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(out, f)
        os.replace(tmp, cache_path)  # a concurrent reader never sees half a file
    return out
