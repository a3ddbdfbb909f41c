"""table_cache.hit_rate: hits over lookups of the build-table cache, %:
tables, build-side and probe-side partition layouts together, over the
window."""
from bench.records import Readings

KINDS = ("", "partition_", "probe_partition_")


def read(r: Readings):
    hits = sum(r.cache.get(f"{k}hits", 0) for k in KINDS)
    lookups = hits + sum(r.cache.get(f"{k}misses", 0) for k in KINDS)
    return 100.0 * hits / lookups if lookups else None
