"""SSD intra-chunk kernel (H), as ``repro/kernels/ssd``: ``ssd`` holds
the kernel's wrapper ``ssd_intra_chunk`` (CUDA tensors only; it
re-exports the oracle as ``ssd_intra_chunk_plain``), ``ref`` the oracle
``ssd_intra_chunk_ref`` and ``ops`` the dispatcher the layers call."""
from . import ssd  # noqa: F401
from .ssd import ssd_intra_chunk, ssd_intra_chunk_plain  # noqa: F401
