"""Feature-space debug and visualisation ops (reference: utils/operations.py).

Counterpart of ``few_shot_seg_cwt_tpu.ops.feature_ops``. Nothing in either
package calls them; they are kept for completeness:

* ``pca``: (N, C) features projected on their first k principal components
  (feature-map visualisation, reference utils/operations.py:35-54);
* ``generate_location_features``: normalised (y, x) coordinate grids
  (reference :60-81);
* ``normalized_conv_weights``: classifier weights L2-normalised per class
  (reference NormConv2d :7-13);
* ``get_binary_logits``: K-way logits collapsed to (bg, fg) for one class.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def pca(features: torch.Tensor, k: int = 3) -> torch.Tensor:
    """(N, C) -> (N, k) principal-component projection (SVD-based)."""
    x = torch.as_tensor(features).float()
    x = x - x.mean(dim=0, keepdim=True)
    _, _, vt = torch.linalg.svd(x, full_matrices=False)
    return x @ vt[:k].T


def generate_location_features(hw: Tuple[int, int]) -> np.ndarray:
    """(h, w) -> (h, w, 2) normalised (y, x) coordinates in [0, 1]."""
    h, w = hw
    ys = np.linspace(0.0, 1.0, h, dtype=np.float32)
    xs = np.linspace(0.0, 1.0, w, dtype=np.float32)
    grid_y, grid_x = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([grid_y, grid_x], axis=-1)


def normalized_conv_weights(weights: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """(C, K) classifier weights L2-normalised along the channel axis."""
    n = torch.sqrt(torch.sum(weights ** 2, dim=0, keepdim=True))
    return weights / torch.clamp(n, min=eps)


def get_binary_logits(logits: torch.Tensor, fg_idx: int) -> torch.Tensor:
    """(..., K) -> (..., 2): background the max over the other classes,
    foreground class ``fg_idx``."""
    k = logits.shape[-1]
    mask = torch.arange(k, device=logits.device) == fg_idx
    bg = torch.where(mask, torch.full_like(logits, -torch.inf), logits).amax(dim=-1)
    return torch.stack([bg, logits[..., fg_idx]], dim=-1)
