"""Co-processed relational operators beyond the inner equi-join.

Counterpart of ``repro/ops``.  Ported so far:

  * ``groupby`` — hash group-by aggregation over the radix-partition data
    path (count/sum/min/max/avg), C/G ratio-split like PHJ.

Importing this package attaches ``CoProcessor.groupby``.  The join
variants (semi / anti / left-outer) are still to port.
"""
from .groupby import (GROUP_PAD_KEY, GroupByResult, grouped_agg,
                      groupby_coprocessed, groupby_ref)

__all__ = [n for n in dir() if not n.startswith("_")]
