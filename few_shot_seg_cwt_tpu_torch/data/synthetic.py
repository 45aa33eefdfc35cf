"""Synthetic episode generation for tests, smoke runs and benchmarks.

A numpy copy of ``few_shot_seg_cwt_tpu.data.synthetic``: the same seed gives
the same episodes bit for bit. Episodes have blob foregrounds whose colour
signature is shared by support and query, so the inner loop and the CWT have
signal to exploit.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def _blob_mask(rng: np.random.Generator, size: int) -> np.ndarray:
    """Random elliptical blob occupying ~5-40% of the image."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    cy, cx = rng.uniform(0.25, 0.75, 2)
    ry, rx = rng.uniform(0.12, 0.35, 2)
    theta = rng.uniform(0, np.pi)
    y, x = yy - cy, xx - cx
    yr = y * np.cos(theta) - x * np.sin(theta)
    xr = y * np.sin(theta) + x * np.cos(theta)
    return ((yr / ry) ** 2 + (xr / rx) ** 2 < 1.0).astype(np.int32)


def make_episode(rng: np.random.Generator, size: int = 473, shot: int = 1,
                 num_classes_pool: int = 16) -> Dict[str, np.ndarray]:
    cls = int(rng.integers(1, num_classes_pool + 1))
    cls_rng = np.random.default_rng(1000 + cls)
    fg_color = cls_rng.uniform(-1.5, 1.5, size=3).astype(np.float32)

    def render():
        mask = _blob_mask(rng, size)
        img = rng.normal(0.0, 0.4, size=(size, size, 3)).astype(np.float32)
        img += mask[..., None] * fg_color
        return img, mask

    s_imgs, s_labels = zip(*(render() for _ in range(shot)))
    q_img, q_label = render()
    return {
        "s_img": np.stack(s_imgs).astype(np.float32),
        "s_label": np.stack(s_labels).astype(np.int32),
        "q_img": q_img,
        "q_label": q_label,
        "cls": np.int32(cls),
        "n_shot": np.int32(shot),
    }


class SyntheticEpisodicDataset:
    """Index-addressable synthetic episodes."""

    def __init__(self, cfg, length: int = 10_000, seed: int = 2021):
        self.size = cfg.image_size
        self.shot = cfg.shot
        self.length = length
        self.seed = seed
        # class ids stay within [1, num_classes_tr - 1] for multi-way configs
        k = int(cfg.get("num_classes_tr", 2))
        self.num_classes_pool = min(16, k - 1) if k > 2 else 16

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 100_003 + index)
        return make_episode(rng, size=self.size, shot=self.shot,
                            num_classes_pool=self.num_classes_pool)


def make_episode_batch(seed: int, e: int, size: int = 473, shot: int = 1
                       ) -> Dict[str, np.ndarray]:
    """Directly build a collated batch of e episodes (bench helper)."""
    records = [
        make_episode(np.random.default_rng(seed * 100_003 + i), size=size, shot=shot)
        for i in range(e)
    ]
    return collate(records)


def collate(records) -> Dict[str, np.ndarray]:
    return {k: np.stack([r[k] for r in records]) for k in records[0]}


class SequentialBatches:
    """Collated batches over ``dataset`` in index order, endless: each
    iteration starts at index 0 and wraps around at the end, dropping a short
    tail (the validation order of the JAX package's loader)."""

    def __init__(self, dataset, batch_size: int):
        if len(dataset) < batch_size:
            raise ValueError(
                f"dataset of {len(dataset)} items < batch_size {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n_batches = len(self.dataset) // self.batch_size
        while True:
            for b in range(n_batches):
                yield collate([self.dataset[b * self.batch_size + i]
                               for i in range(self.batch_size)])
