"""SSD intra-chunk kernel (H): ``ssd`` holds the wrapper
``ssd_intra_chunk`` and its plain version ``ssd_intra_chunk_plain``, as
``repro/kernels/ssd`` holds the Pallas kernel and its oracle."""
from . import ssd  # noqa: F401
from .ssd import ssd_intra_chunk, ssd_intra_chunk_plain  # noqa: F401
