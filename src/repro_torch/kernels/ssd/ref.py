"""Plain PyTorch oracle of kernel H: the Mamba2 SSD intra-chunk term.

Counterpart of ``repro/kernels/ssd/ref.py`` (the einsums of
``ssd_chunked``), except that it returns float32 where the JAX oracle
returns x's dtype: ``ssd_chunked`` adds the inter-chunk term before it
casts.  The wrapper in ``ssd.py`` runs it on CPU tensors as
``ssd_intra_chunk_plain``.
"""
from __future__ import annotations

import torch


def ssd_intra_chunk_ref(x, dt, b, c, a) -> torch.Tensor:
    """Y_intra (B, NC, Q, H, P) float32 of x (B, NC, Q, H, P); dt
    (B, NC, Q, H); b, c (B, NC, Q, N); a (H,)."""
    # Imported here: repro_torch.layers.ssd imports the kernel.
    from ...layers.ssd import _segsum

    dtf = dt.float()
    da = dtf * a.float()
    # The exponential in float64: PyTorch's multi-threaded float32 exp on
    # the CPU is off by up to 1e-4 in some processes.
    l_mat = torch.exp(_segsum(da.permute(0, 1, 3, 2)).double()).float()
    scores = torch.einsum("bcqn,bckn->bcqk", c.float(), b.float())
    m = scores[:, :, None] * l_mat
    return torch.einsum("bchqk,bckh,bckhp->bcqhp", m, dtf, x.float())
