"""Keypoint-transfer geometry helpers (semantic-correspondence utilities).

Counterpart of ``few_shot_seg_cwt_tpu.ops.geometry`` (reference:
src/model/base/geometry.py:9-136): keypoint normalisation, attentive
indexing, argmax-centred Gaussian re-weighting of correlation rows and
weighted-average keypoint transfer. No trainer calls these (they come from
the upstream CHM repo's PF-PASCAL evaluation); they are kept, as the JAX
package keeps them, for API completeness.

Keypoint sets are padded to a fixed ``max_pts`` with a validity count
``n_pts``; absent keypoints carry the reference's -2 sentinel
(geometry.py:29,97), which the (un)normalisation passes through.
"""

from __future__ import annotations

import numpy as np
import torch

_PAD = -2.0  # reference sentinel for absent keypoints


def normalize_kps(kps: torch.Tensor, img_size: int) -> torch.Tensor:
    """Pixel coordinates into [-1, 1]; -2 entries pass through."""
    half = img_size // 2
    return torch.where(kps != _PAD, (kps - half) / half, kps)


def unnormalize_kps(kps: torch.Tensor, img_size: int) -> torch.Tensor:
    """Inverse of ``normalize_kps``."""
    half = img_size // 2
    return torch.where(kps != _PAD, kps * half + half, kps)


def _norm_grid(spatial_side: int, device=None) -> torch.Tensor:
    """(side, side, 2) xy grid over [-1, 1]: x varies along columns."""
    g = np.linspace(-1.0, 1.0, spatial_side, dtype=np.float32)
    gx, gy = np.meshgrid(g, g)
    return torch.as_tensor(np.stack([gx, gy], axis=-1), device=device)


def attentive_indexing(kps: torch.Tensor, spatial_side: int,
                       thres: float = 0.1) -> torch.Tensor:
    """Soft assignment of normalised keypoints (N, 2) to grid cells:
    (N, side, side) weights summing to 1 per keypoint."""
    grid = _norm_grid(spatial_side, kps.device)
    d2 = torch.sum((grid[None] - kps[:, None, None, :]) ** 2, dim=-1)
    att = torch.clamp(thres - torch.sqrt(d2 + 1e-5), min=0.0).reshape(kps.shape[0], -1)
    att = att / (torch.sum(att, dim=1, keepdim=True) + 1e-30)
    return att.reshape(kps.shape[0], spatial_side, spatial_side)


def apply_gaussian_kernel(corr: torch.Tensor, spatial_side: int,
                          sigma: float = 17.0) -> torch.Tensor:
    """Each row of corr (B, P, side*side) times a Gaussian centred at the
    row's argmax."""
    center = torch.argmax(corr, dim=2)
    cy = torch.div(center, spatial_side, rounding_mode="floor").float()
    cx = (center % spatial_side).float()
    idx = torch.arange(spatial_side, dtype=torch.float32, device=corr.device)
    dy = idx[None, None, :] - cy[..., None]
    dx = idx[None, None, :] - cx[..., None]
    g = torch.exp(-(dy[..., :, None] ** 2 + dx[..., None, :] ** 2) / (2.0 * sigma ** 2))
    b, p = corr.shape[:2]
    return g.reshape(b, p, -1) * corr


def transfer_kps(confidence: torch.Tensor, src_kps: torch.Tensor, n_pts: torch.Tensor,
                 img_size: int, normalized: bool = False) -> torch.Tensor:
    """Source keypoints through a correlation volume.

    confidence (B, side², side²) source -> target; src_kps (B, 2, max_pts)
    xy (pixels unless ``normalized``); n_pts (B,) valid counts. Returns
    (B, 2, max_pts) normalised predictions, -2 beyond each count."""
    spatial_side = img_size // 8
    if not normalized:
        src_kps = normalize_kps(src_kps, img_size)
    pdf = torch.softmax(apply_gaussian_kernel(confidence, spatial_side), dim=2)
    grid = _norm_grid(spatial_side, confidence.device).reshape(-1, 2)
    prd_xy = torch.stack([torch.sum(pdf * grid[None, None, :, 0], dim=2),
                          torch.sum(pdf * grid[None, None, :, 1], dim=2)], dim=-1)
    max_pts = src_kps.shape[-1]
    out = []
    for i in range(src_kps.shape[0]):
        att = attentive_indexing(src_kps[i].T, spatial_side).reshape(max_pts, -1)
        prd = att @ prd_xy[i]
        valid = (torch.arange(max_pts, device=prd.device) < n_pts[i])[:, None]
        out.append(torch.where(valid, prd, torch.full_like(prd, _PAD)).T)
    return torch.stack(out)
