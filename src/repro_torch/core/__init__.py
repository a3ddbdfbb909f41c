"""The paper's hash-join co-processing, in PyTorch (counterpart of
``repro.core``).

  * relations + generators           : ``relation``
  * dense bucketed hash table        : ``hash_table``
  * fine-grained steps (SHJ/PHJ)     : ``steps``, ``shj``, ``phj``
  * radix partitioning               : ``partition``
  * the SHJ / PHJ two-group executor : ``coprocess``
  * cost model, pass planner, calibration
  * §3.3 mechanisms: scan allocator (``allocator``), skew grouping
    (``divergence``) and ``CoProcessor.run_map_series``
  * state exchange with the JAX package (NumPy only) : ``interop``
"""
from .relation import (Relation, uniform_relation, unique_relation,
                       skewed_relation, probe_with_selectivity,
                       murmur3_fmix32, bucket_of, radix_of, resolve_device)
from .hash_table import (HashTable, JoinResult, build_hash_table,
                         probe_hash_table, merge_hash_tables, join_oracle,
                         default_num_buckets)
from .shj import shj_join, BUILD_SERIES, PROBE_SERIES
from .phj import (phj_join, phj_coarse_join, partition_series,
                  resolve_schedule, default_shj_bits, phj_bucket_count)
from .partition import (radix_partition, radix_partition_scheduled,
                        radix_partition_unfused, Partitions)
from .pass_planner import (PassPlan, PassPlanner, default_planner,
                           even_schedule, calibrate_partition_unit_costs)
from .cost_model import (SeriesCostModel, series_model_from_costs, LinkSpec,
                         DeviceSpec, PCIE_LINK, ICI_LINK, DCN_LINK,
                         ZEROCOPY_LINK)
from .coprocess import CoProcessor, Timing, DeviceGroup
from .calibrate import OnlineUnitCosts, calibrated_overrides
from .allocator import scan_alloc, alloc_stats, basic_alloc_units
from .divergence import (divergence_order, inverse_permutation,
                         tile_divergence_waste)

__all__ = [n for n in dir() if not n.startswith("_")]
