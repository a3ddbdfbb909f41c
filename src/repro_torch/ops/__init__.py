"""Co-processed relational operators beyond the inner equi-join.

Counterpart of ``repro/ops``:

  * ``groupby`` — hash group-by aggregation over the radix-partition data
    path (count/sum/min/max/avg), C/G ratio-split like PHJ.
  * ``join_variants`` — semi / anti / left-outer joins over the probe
    series, run through ``CoProcessor.probe_table`` by
    ``probe_table_variant``.

Importing this package attaches ``CoProcessor.groupby``.
"""
from .groupby import (GROUP_PAD_KEY, GroupByResult, grouped_agg,
                      groupby_coprocessed, groupby_ref)
from .join_variants import (JOIN_KINDS, NULL_RID, join_variant_oracle,
                            probe_hash_table_variant, probe_table_variant)

__all__ = [n for n in dir() if not n.startswith("_")]
