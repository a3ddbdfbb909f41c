"""Dispatcher for the segmented-aggregation kernel.

``segmented_aggregate`` is the data path behind group-by's reduce step
(``repro_torch.ops.groupby`` routes through it): kernel C on a CUDA tensor
at every size and slot count, its plain version on a CPU tensor.
"""
from .agg import seg_agg, wide_chunk_bits, wide_sums_to_int64

__all__ = ["segmented_aggregate", "wide_sums_to_int64"]


def segmented_aggregate(gid, val, *, num_slots: int, wrap32: bool = False):
    """Per-slot (count, sum, min, max) of ``val`` grouped by ``gid``.

    ``gid == -1`` marks pad tuples (contribute nothing).  Sums are wide by
    default — a (chunks+1, num_slots) int32 chunk layout with exact int64
    semantics, chunk width adapted to the input size (to ~143M rows per
    call) and decoded by ``wide_sums_to_int64`` — or a single wrapping
    int32 vector under ``wrap32=True``.  Empty slots report
    (0, 0, INT32_MAX, INT32_MIN).
    """
    if not wrap32:
        wide_chunk_bits(gid.shape[0])    # raise early past the hard cap
    return seg_agg(gid, val, num_slots=num_slots, wrap32=wrap32)
