"""The port's ops. Importing the package registers the hand-written kernels
as PyTorch operators (``fss::adapt_binary``, ``fss::adapt_binary_tiled``,
``fss::pivot_fwd``, ``fss::pivot_dw``, ``fss::hough4d``), so a program saved by
``torch.export`` that calls them loads with this package alone; each
kernel is built at its first launch and counts each launch under its name
(``utils.tracing.count``): ``launch_counts`` reads them."""

from typing import Dict

from ..utils import tracing
from . import cuda_hough, cuda_inner_loop, cuda_pivot  # noqa: F401  (registers the operators)
from .resize import (
    adaptive_avg_pool,
    adaptive_pool_matrix,
    interp_matrix_align_corners,
    resize_nearest,
    upsample_bilinear_ac,
)
from .losses import (
    binary_weighted_ce_from_diff,
    class_balance_weights,
    cross_entropy,
    seg_loss,
    smoothed_cross_entropy,
    weighted_cross_entropy,
    weighted_dice_loss,
)
from .corr import (
    get_corr,
    l2norm,
    masked_attention_readout,
    mutual_matching,
    mutual_matching_bqsc,
    mutual_matching_flat,
    mutual_nn_filter,
)
from .metrics import intersection_and_union

# the hand-written kernels, by the names their launches are counted under
KERNELS = ("adapt_binary", "adapt_binary_tiled", "pivot_fwd", "pivot_dw", "hough4d")


def launch_counts(*names: str) -> Dict[str, int]:
    """Each kernel's launches (or those of the kernels ``names``) since the
    counters' last ``tracing.reset()``."""
    counts = tracing.counts()
    return {k: counts[k] for k in names or KERNELS}


__all__ = [
    "KERNELS",
    "launch_counts",
    "adaptive_avg_pool",
    "adaptive_pool_matrix",
    "interp_matrix_align_corners",
    "resize_nearest",
    "upsample_bilinear_ac",
    "binary_weighted_ce_from_diff",
    "class_balance_weights",
    "cross_entropy",
    "seg_loss",
    "smoothed_cross_entropy",
    "weighted_cross_entropy",
    "weighted_dice_loss",
    "get_corr",
    "l2norm",
    "masked_attention_readout",
    "mutual_matching",
    "mutual_matching_bqsc",
    "mutual_matching_flat",
    "mutual_nn_filter",
    "intersection_and_union",
]
