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
