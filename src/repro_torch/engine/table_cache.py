"""Build-table cache — the paper's cache-reuse insight at the query level.

The paper's coupled-architecture win partly comes from the build table
staying resident in the shared cache between phases (§3.3, Table 3:
fine-grained steps "reuse the hash table in cache" where coarse-grained
private tables cannot).  A query *engine* gets the same effect one level
up: across queries, repeated probes against a hot build relation should
find the finished hash table already resident and skip the build phase
entirely.

``BuildTableCache`` is an LRU keyed by a content fingerprint of the build
relation (plus the bucket count, since tables of different geometry are not
interchangeable), bounded by a byte budget over the dense CSR arrays.

Counterpart of ``repro/engine/table_cache.py``: the same keys (the
fingerprint hashes the same bytes in the same order, so its digest equals
the reference's for the same relation) and the same byte sizes.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

from ..core.relation import Relation


def relation_fingerprint(rel: Relation, num_buckets: int) -> str:
    """Content hash of a build relation + table geometry.

    Hashes the host bytes of both columns, so regenerating an identical
    relation (same generator, same seed) hits the same cache line even
    though the tensor objects differ.  A column on the card is pulled to
    the host first (``.cpu()``, which waits for the device).
    """
    h = hashlib.sha1()
    h.update(rel.key.cpu().numpy().tobytes())
    h.update(rel.rid.cpu().numpy().tobytes())
    h.update(f"|n={rel.size}|b={num_buckets}".encode())
    return h.hexdigest()


def table_nbytes(table) -> int:
    """Bytes of a cached object: a ``HashTable``'s CSR arrays or a
    partitioned layout's two columns (``Relation.nbytes``)."""
    return int(table.nbytes)


def partition_layout_key(fingerprint: str, schedule, side: str = "R") -> str:
    """Cache key for a PHJ partitioned layout: content + pass schedule.

    Layouts produced under different radix schedules assign different
    partition ids, so they are not interchangeable.  ``side`` separates
    build ("R") from probe ("S") layouts: both are cached since the
    probe-side satellite, and the pad sentinels baked into a padded layout
    differ per side.
    """
    sched = tuple(int(b) for b in schedule)
    tag = "" if side == "R" else f"|side={side}"
    return f"part:{fingerprint}|sched={sched}{tag}"


class BuildTableCache:
    """LRU cache of finished build state under one byte budget.  Thread-safe.

    Two kinds of entries share the budget and the LRU order:

      * **hash tables** (SHJ) — the finished CSR table; a hit runs
        probe-only.
      * **partitioned layouts** (PHJ) — the build relation after its n1–n3
        radix passes (``partition_layout_key``); a hit skips the build-side
        partition passes, the PHJ analogue of table reuse (ROADMAP open
        item: "caching partitions would extend the reuse story").

    Hit/miss counters are kept per kind so ``stats()`` can attribute reuse.
    """

    def __init__(self, budget_bytes: int = 256 << 20,
                 tenant_budget_bytes=None):
        self.budget_bytes = int(budget_bytes)
        # Optional per-tenant byte cap (ROADMAP item 1 remainder): an int
        # applies the same cap to every tenant, a dict caps only the named
        # tenants.  A tenant over its own cap evicts its own LRU entries
        # *before* the shared-capacity sweep can touch anyone else's.
        self.tenant_budget_bytes = tenant_budget_bytes
        # key -> (obj, nbytes, owner_tenant, kind); the owner is whoever
        # inserted the entry — eviction attribution needs the victim's
        # identity, not just its key.
        self._entries: OrderedDict[str, tuple] = OrderedDict()
        self._tenant_bytes: dict[str, int] = {}
        self._registry = None          # optional MetricsRegistry
        self._lock = threading.Lock()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.evictions = 0
        self.budget_evictions = 0
        self.partition_hits = 0
        self.partition_misses = 0
        self.partition_puts = 0
        self.probe_partition_hits = 0
        self.probe_partition_misses = 0
        self.probe_partition_puts = 0

    def __len__(self) -> int:
        return len(self._entries)

    def peek(self, key: str):
        """Lookup without touching stats or LRU order.

        The engine peeks before planning: a resident table the planner
        then decides *not* to use (PHJ wins) is neither a hit nor a miss.
        """
        with self._lock:
            ent = self._entries.get(key)
            return ent[0] if ent is not None else None

    def _emit(self, name: str, tenant: str, kind: str) -> None:
        """Per-tenant labeled counter into the attached registry.  Called
        *after* the cache lock is released (the service's lock discipline:
        components do not call into the registry under their own locks)."""
        if self._registry is not None:
            self._registry.inc(name, tenant=tenant, kind=kind)

    def get(self, key: str, tenant: str = "default"):
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
            else:
                self._entries.move_to_end(key)
                self.hits += 1
        self._emit("cache_hits" if ent is not None else "cache_misses",
                   tenant, "table")
        return ent[0] if ent is not None else None

    def record_miss(self, tenant: str = "default"):
        """Count a lookup that found nothing (pairs with ``peek``)."""
        with self._lock:
            self.misses += 1
        self._emit("cache_misses", tenant, "table")

    def put(self, key: str, table, tenant: str = "default") -> bool:
        """Insert; evicts LRU entries until under budget.  Returns False if
        the table alone exceeds the whole budget (not cached)."""
        return self._put(key, table, "table", tenant)

    # -- partitioned layouts (PHJ build side) -------------------------------
    def peek_partition(self, key: str):
        """Partition-layout lookup without touching stats or LRU order."""
        return self.peek(key)

    def get_partition(self, key: str, tenant: str = "default"):
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.partition_misses += 1
            else:
                self._entries.move_to_end(key)
                self.partition_hits += 1
        self._emit("cache_hits" if ent is not None else "cache_misses",
                   tenant, "partition")
        return ent[0] if ent is not None else None

    def record_partition_miss(self, tenant: str = "default"):
        with self._lock:
            self.partition_misses += 1
        self._emit("cache_misses", tenant, "partition")

    def put_partition(self, key: str, layout,
                      tenant: str = "default") -> bool:
        return self._put(key, layout, "partition", tenant)

    # -- probe-side partitioned layouts (satellite: probe reuse) ------------
    def get_probe_partition(self, key: str, tenant: str = "default"):
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.probe_partition_misses += 1
            else:
                self._entries.move_to_end(key)
                self.probe_partition_hits += 1
        self._emit("cache_hits" if ent is not None else "cache_misses",
                   tenant, "probe_partition")
        return ent[0] if ent is not None else None

    def record_probe_partition_miss(self, tenant: str = "default"):
        with self._lock:
            self.probe_partition_misses += 1
        self._emit("cache_misses", tenant, "probe_partition")

    def put_probe_partition(self, key: str, layout,
                            tenant: str = "default") -> bool:
        return self._put(key, layout, "probe_partition", tenant)

    def _tenant_cap(self, tenant: str):
        cap = self.tenant_budget_bytes
        if cap is None:
            return None
        if isinstance(cap, dict):
            cap = cap.get(tenant)
            return None if cap is None else int(cap)
        return int(cap)

    def _evict_locked(self, key: str, evicted: list, reason: str) -> None:
        _, ev_bytes, ev_tenant, ev_kind = self._entries.pop(key)
        self.bytes -= ev_bytes
        left = self._tenant_bytes.get(ev_tenant, 0) - ev_bytes
        if left > 0:
            self._tenant_bytes[ev_tenant] = left
        else:
            self._tenant_bytes.pop(ev_tenant, None)
        self.evictions += 1
        if reason == "tenant_budget":
            self.budget_evictions += 1
        evicted.append((key, ev_bytes, ev_tenant, ev_kind, reason))

    def _put(self, key: str, obj, kind: str,
             tenant: str = "default") -> bool:
        nbytes = table_nbytes(obj)
        if nbytes > self.budget_bytes:
            return False
        cap = self._tenant_cap(tenant)
        if cap is not None and nbytes > cap:
            return False        # mirrors the whole-budget rule: not cached
        evicted = []
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return True
            self._entries[key] = (obj, nbytes, tenant, kind)
            self.bytes += nbytes
            self._tenant_bytes[tenant] = \
                self._tenant_bytes.get(tenant, 0) + nbytes
            if kind == "partition":
                self.partition_puts += 1
            elif kind == "probe_partition":
                self.probe_partition_puts += 1
            else:
                self.puts += 1
            # Per-tenant budget first: a hot tenant over its own cap evicts
            # its OWN oldest entries (never the one just inserted — the
            # entry alone fits the cap, so an older one must exist) before
            # the shared sweep below can push out anyone else's.
            if cap is not None:
                while self._tenant_bytes.get(tenant, 0) > cap:
                    victim = next(k for k, e in self._entries.items()
                                  if e[2] == tenant and k != key)
                    self._evict_locked(victim, evicted, "tenant_budget")
            while self.bytes > self.budget_bytes:
                self._evict_locked(next(iter(self._entries)), evicted,
                                   "capacity")
        # Eviction attribution (outside the lock): which tenant's insert
        # pushed out which tenant's entry, and whether the victim fell to
        # its owner's budget or to shared capacity (ROADMAP item 1).
        if self._registry is not None:
            for ev_key, ev_bytes, ev_tenant, ev_kind, reason in evicted:
                self._registry.inc("cache_evictions", tenant=ev_tenant,
                                   kind=ev_kind)
                if reason == "tenant_budget":
                    self._registry.inc("cache_budget_evictions",
                                       tenant=ev_tenant, kind=ev_kind)
                self._registry.event(
                    "cache_eviction", evictor=tenant, victim=ev_tenant,
                    kind=ev_kind, nbytes=int(ev_bytes), reason=reason,
                    key=ev_key[:16])
        return True

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._tenant_bytes.clear()
            self.bytes = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    @property
    def partition_hit_rate(self) -> float:
        total = self.partition_hits + self.partition_misses
        return self.partition_hits / total if total else 0.0

    def register_metrics(self, registry, name: str = "cache") -> None:
        """Expose this cache's counters as a ``MetricsRegistry`` collector
        and attach the registry for per-tenant hit/miss/eviction series
        (``cache_hits{tenant=..,kind=..}`` etc.) plus eviction-attribution
        events.

        ``stats()`` reads everything under the cache's own lock, and the
        registry invokes collectors outside its lock, so the engine's
        lock-ordering rule (registry lock is a leaf) holds; per-tenant
        emission likewise happens after the cache lock is released.
        """
        self._registry = registry
        registry.register_collector(name, self.stats)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self.bytes,
                    "budget_bytes": self.budget_bytes, "hits": self.hits,
                    "misses": self.misses, "puts": self.puts,
                    "evictions": self.evictions,
                    "budget_evictions": self.budget_evictions,
                    "tenant_bytes": dict(self._tenant_bytes),
                    "hit_rate": self.hit_rate,
                    "partition_hits": self.partition_hits,
                    "partition_misses": self.partition_misses,
                    "partition_puts": self.partition_puts,
                    "partition_hit_rate": self.partition_hit_rate,
                    "probe_partition_hits": self.probe_partition_hits,
                    "probe_partition_misses": self.probe_partition_misses,
                    "probe_partition_puts": self.probe_partition_puts}
