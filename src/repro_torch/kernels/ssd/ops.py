"""Dispatcher for kernel H.

Counterpart of ``repro/kernels/ssd/ops.py``.  ``ssd_intra_chunk`` is what
``layers/ssd.py: ssd_chunked`` calls: the oracle ``ref.ssd_intra_chunk_ref``
on a CPU tensor, kernel H (``ssd.ssd_intra_chunk``, in the variant its
dtype selects) on a CUDA tensor.  The choice follows x's device alone,
with no fallback between the two: what the kernel does not take raises.
"""
from __future__ import annotations

import torch

from . import ssd as _kernel
from .ref import ssd_intra_chunk_ref


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Y_intra (B, NC, Q, H, P) float32 of x (B, NC, Q, H, P); dt
    (B, NC, Q, H); b, c (B, NC, Q, N); a (H,)."""
    if x.device.type == "cpu":
        return ssd_intra_chunk_ref(x, dt, b, c, a)
    return _kernel.ssd_intra_chunk(x, dt, b, c, a)
