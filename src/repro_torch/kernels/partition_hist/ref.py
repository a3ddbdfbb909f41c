"""Plain PyTorch versions of the radix-partition kernels.

Counterpart of ``repro/kernels/partition_hist/ref.py``; the fused
versions live beside their kernels in ``fused.py`` and ``reorder.py``.
"""
import torch

from .fused import partition_hist_fused_plain as partition_hist_fused_ref
from .reorder import radix_scatter_plain as radix_scatter_ref


def radix_hist_ref(pid: torch.Tensor, *, num_parts: int) -> torch.Tensor:
    return torch.bincount(pid, minlength=num_parts).to(torch.int32)


__all__ = ["partition_hist_fused_ref", "radix_hist_ref", "radix_scatter_ref"]
