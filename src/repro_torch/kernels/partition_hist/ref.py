"""Plain PyTorch versions of the radix-partition kernels.

Counterpart of ``repro/kernels/partition_hist/ref.py``; the plain
versions live beside their kernels in ``fused.py``, ``partition_hist.py``
and ``reorder.py``.
"""
from .fused import partition_hist_fused_plain as partition_hist_fused_ref
from .partition_hist import radix_hist_plain as radix_hist_ref
from .reorder import radix_scatter_plain as radix_scatter_ref

__all__ = ["partition_hist_fused_ref", "radix_hist_ref", "radix_scatter_ref"]
