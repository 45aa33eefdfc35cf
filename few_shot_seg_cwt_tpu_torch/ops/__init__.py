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
    weighted_cross_entropy,
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
    "weighted_cross_entropy",
    "intersection_and_union",
]
