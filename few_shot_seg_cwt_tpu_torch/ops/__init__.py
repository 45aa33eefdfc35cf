"""The port's ops. Importing the package registers the hand-written kernels
as PyTorch operators (``fss::adapt_binary``, ``fss::adapt_binary_tiled``,
``fss::pivot_fwd``, ``fss::pivot_dw``), so a program saved by
``torch.export`` that calls them loads with this package alone; each
kernel is built at its first launch."""

from . import cuda_inner_loop, cuda_pivot  # noqa: F401  (registers the operators)
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

__all__ = [
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
