"""Confusion-matrix style IoU trackers (reference: utils/metrics.py:4-88); the
port's copy of ``few_shot_seg_cwt_tpu.utils.extra_metrics``.

``BinaryIoU`` accumulates FG/BG intersections/unions over episodes;
``FullIoU`` keeps a full confusion matrix for multi-class evaluation. Both
accept numpy arrays (host-side accumulation of device-computed predictions).
"""

from __future__ import annotations

import numpy as np


class BinaryIoU:
    def __init__(self, ignore_index: int = 255):
        self.ignore_index = ignore_index
        self.inter = np.zeros(2)
        self.union = np.zeros(2)

    def update(self, pred: np.ndarray, target: np.ndarray) -> None:
        valid = target != self.ignore_index
        for c in (0, 1):
            p = (pred == c) & valid
            t = (target == c) & valid
            self.inter[c] += np.sum(p & t)
            self.union[c] += np.sum(p | t)

    @property
    def iou(self) -> np.ndarray:
        return self.inter / np.maximum(self.union, 1e-10)

    @property
    def miou(self) -> float:
        return float(self.iou.mean())


class FullIoU:
    def __init__(self, num_classes: int, ignore_index: int = 255):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.confusion = np.zeros((num_classes, num_classes), np.int64)

    def update(self, pred: np.ndarray, target: np.ndarray) -> None:
        valid = (target != self.ignore_index) & (target < self.num_classes)
        p = pred[valid].astype(np.int64)
        t = target[valid].astype(np.int64)
        idx = t * self.num_classes + np.clip(p, 0, self.num_classes - 1)
        self.confusion += np.bincount(
            idx, minlength=self.num_classes**2
        ).reshape(self.num_classes, self.num_classes)

    @property
    def iou(self) -> np.ndarray:
        inter = np.diag(self.confusion).astype(np.float64)
        union = (
            self.confusion.sum(0) + self.confusion.sum(1) - np.diag(self.confusion)
        )
        return inter / np.maximum(union, 1e-10)

    @property
    def miou(self) -> float:
        return float(self.iou.mean())

    @property
    def pixel_accuracy(self) -> float:
        return float(np.diag(self.confusion).sum() / max(self.confusion.sum(), 1))
