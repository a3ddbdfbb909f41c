"""Segmented-aggregation kernel (hash group-by's inner loop)."""
from .ops import segmented_aggregate, wide_sums_to_int64  # noqa: F401
