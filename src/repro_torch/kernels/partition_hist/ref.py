"""Plain PyTorch versions of the radix-partition kernels, and clustered
pid vectors to hold kernel E against its plain version.

Counterpart of ``repro/kernels/partition_hist/ref.py``; the plain
versions live beside their kernels in ``fused.py``, ``partition_hist.py``
and ``reorder.py``.
"""
import numpy as np
import torch

from .fused import partition_hist_fused_plain as partition_hist_fused_ref
from .partition_hist import radix_hist_plain as radix_hist_ref
from .reorder import radix_scatter_plain as radix_scatter_ref

__all__ = ["clustered_pids", "partition_hist_fused_ref", "radix_hist_ref",
           "radix_scatter_ref"]


def clustered_pids(n: int, num_parts: int, *, seed: int,
                   device="cpu") -> torch.Tensor:
    """n int32 pids in runs, as the final headers of a partitioned
    relation see them: uniform pids in [0, P) sorted, so a run holds
    about n / P equal pids and crosses vector, warp and block edges, with
    about one pid in 5000 set to -1, P or P + 1 inside the runs.  Made
    from a NumPy seed."""
    rng = np.random.default_rng(seed)
    pid = np.sort(rng.integers(0, num_parts, n)).astype(np.int32)
    for bad in (-1, num_parts, num_parts + 1):
        pid[rng.integers(0, max(n, 1), 1 + n // 5000)[: n]] = bad
    return torch.from_numpy(pid).to(device)
