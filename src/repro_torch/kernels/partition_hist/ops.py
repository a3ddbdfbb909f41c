"""Dispatchers for the radix-partition kernels.

``fused_partition_pass`` is the data path behind one radix pass
(``repro_torch.core.partition`` routes through it).  A CUDA relation goes
through kernel A (n1+n2, ``fused.py``) and kernel B (n3, ``reorder.py``)
at every size; a CPU relation goes through their plain versions.
``radix_hist`` (kernel E, ``partition_hist.py``) is step n2 on its own,
behind ``partition_n2``.
"""
import torch

from .fused import partition_hist_fused
from .partition_hist import radix_hist, radix_hist_op
from .reorder import radix_scatter

__all__ = ["fused_partition_pass", "radix_hist", "radix_hist_op"]


def fused_partition_pass(rel, *, shift: int, bits: int):
    """One full radix pass (n1+n2+n3).

    Returns ``(reordered Relation, starts, counts)`` for the ``bits``-wide
    digit at ``shift``; the reorder is a stable clustering by that digit.
    """
    from repro_torch.core.relation import Relation

    pid, counts = partition_hist_fused(rel.key, shift=shift, bits=bits)
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    rid, key = radix_scatter(rel.rid, rel.key, pid, starts,
                             num_parts=1 << bits)
    return Relation(rid, key), starts, counts
