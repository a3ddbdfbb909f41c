"""Plain PyTorch version of the segmented-aggregation kernel.

Counterpart of ``repro/kernels/agg/ref.py`` (the same semantics as its
``seg_agg_ref``); it lives beside its kernel in ``agg.py``.
"""
from .agg import seg_agg_plain as seg_agg_ref

__all__ = ["seg_agg_ref"]
