"""Qualitative output: mask overlays and episode composites (the port's copy
of ``few_shot_seg_cwt_tpu.utils.visualize``).

Parity with the reference visualizer (reference: mask.py:25-123 ``Masker``):
denormalize images, colorize binary/multi-class masks, blend overlays, and
save support|query|prediction composites for qualitative inspection.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

# 21-entry PASCAL palette (class 0 = background), cycled for larger ids
_PALETTE = np.array(
    [
        [0, 0, 0], [128, 0, 0], [0, 128, 0], [128, 128, 0], [0, 0, 128],
        [128, 0, 128], [0, 128, 128], [128, 128, 128], [64, 0, 0], [192, 0, 0],
        [64, 128, 0], [192, 128, 0], [64, 0, 128], [192, 0, 128], [64, 128, 128],
        [192, 128, 128], [0, 64, 0], [128, 64, 0], [0, 192, 0], [128, 192, 0],
        [0, 64, 128],
    ],
    dtype=np.uint8,
)


def decode_seg_map(mask: np.ndarray, ignore_index: int = 255) -> np.ndarray:
    """(H, W) int mask -> (H, W, 3) uint8 colors; ignore pixels are white."""
    out = _PALETTE[np.mod(mask.astype(np.int64), len(_PALETTE))]
    out[mask == ignore_index] = 255
    return out


class Masker:
    """Builds and saves image/mask composites."""

    def __init__(self, mean: Sequence[float] = (0.485, 0.456, 0.406),
                 std: Sequence[float] = (0.229, 0.224, 0.225),
                 alpha: float = 0.5):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.alpha = alpha

    def denormalize(self, img: np.ndarray) -> np.ndarray:
        """(H, W, 3) normalized float -> uint8 RGB."""
        x = (img * self.std + self.mean) * 255.0
        return np.clip(x, 0, 255).astype(np.uint8)

    def overlay(self, img: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Blend a colorized mask onto a (de)normalized image."""
        rgb = self.denormalize(img) if img.dtype != np.uint8 else img
        color = decode_seg_map(mask)
        fg = (mask != 0) & (mask != 255)
        out = rgb.copy()
        out[fg] = (
            (1 - self.alpha) * rgb[fg].astype(np.float32)
            + self.alpha * color[fg].astype(np.float32)
        ).astype(np.uint8)
        return out

    def episode_composite(
        self,
        s_imgs: np.ndarray,      # (shot, H, W, 3) normalized
        s_labels: np.ndarray,    # (shot, H, W)
        q_img: np.ndarray,       # (H, W, 3)
        q_label: np.ndarray,     # (H, W) ground truth
        pred: Optional[np.ndarray] = None,  # (H, W) prediction
    ) -> np.ndarray:
        """Horizontal strip: supports | query GT | query prediction."""
        panels = [self.overlay(s_imgs[k], s_labels[k]) for k in range(len(s_imgs))]
        panels.append(self.overlay(q_img, q_label))
        if pred is not None:
            panels.append(self.overlay(q_img, pred))
        return np.concatenate(panels, axis=1)

    def save(self, array: np.ndarray, path: str) -> None:
        from PIL import Image

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        Image.fromarray(array).save(path)
