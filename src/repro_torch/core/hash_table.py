"""Dense bucketed hash table: the paper's two-level table in CSR form.

Counterpart of ``repro/core/hash_table.py``.  The bucket header -> key list
-> rid list structure is built with sorts and scans (b1..b4) and probed
with a gather, a bounded binary search and a scan-driven expansion
(p1..p4), step for step as in the JAX package, so every array matches it
bit for bit.  Hazards the port keeps:

* keys sort and compare as uint32 (``build_b2_order``, ``probe_p3``), so
  negative pad keys sort last;
* JAX's ``x[idx]`` clamps out-of-range indices (negatives wrap first);
  torch raises, so the clamps are written out;
* ``cumsum`` of int32 stays int32 (torch would promote to int64).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.csr_probe import csr_probe_join
from .relation import Relation, bucket_of, next_pow2

INVALID = -1
_MASK32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 values reinterpreted as uint32, held in int64."""
    return x.to(torch.int64) & _MASK32


def _cumsum32(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0, dtype=torch.int32)


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor, num: int):
    return torch.zeros(num, dtype=torch.int32, device=vals.device) \
        .index_add_(0, seg, vals.to(torch.int32))


@dataclasses.dataclass
class HashTable:
    """CSR form of the paper's bucket-header -> key-list -> rid-list table."""

    bucket_key_start: torch.Tensor  # (B,) index of the bucket's first key
    bucket_key_count: torch.Tensor  # (B,) unique keys in the bucket
    ukeys: torch.Tensor             # (n,) unique keys by (bucket, key); padded
    key_rid_start: torch.Tensor     # (n,) index of the key's first rid
    key_rid_count: torch.Tensor     # (n,) rids under the key
    rids: torch.Tensor              # (n,) rids, grouped by (bucket, key)
    skeys: torch.Tensor             # (n,) key value per rid slot
    num_keys: torch.Tensor          # scalar int32: valid key entries

    @property
    def num_buckets(self) -> int:
        return int(self.bucket_key_start.shape[0])

    @property
    def capacity(self) -> int:
        return int(self.rids.shape[0])

    def _tensors(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._tensors())

    def to(self, device) -> "HashTable":
        # Not ``dataclasses.astuple``: it deep-copies every tensor first.
        return HashTable(*(t.to(device) for t in self._tensors()))


@dataclasses.dataclass
class JoinResult:
    """Matching ``(probe_rid, build_rid)`` pairs, padded with -1."""

    probe_rid: torch.Tensor
    build_rid: torch.Tensor
    count: torch.Tensor  # scalar int32: number of valid pairs

    def valid_pairs(self) -> np.ndarray:
        """Host-side (count, 2) array of valid pairs, sorted (for tests)."""
        c = int(self.count)
        return sort_pairs(np.stack([self.probe_rid[:c].cpu().numpy(),
                                    self.build_rid[:c].cpu().numpy()],
                                   axis=1))

    def to(self, device) -> "JoinResult":
        return JoinResult(self.probe_rid.to(device),
                          self.build_rid.to(device), self.count.to(device))


def default_num_buckets(n: int, *, avg_bucket: int = 4) -> int:
    """Paper-style sizing: a few tuples per bucket on average, power of two."""
    return max(4, next_pow2(max(1, n // avg_bucket)))


# ---------------------------------------------------------------------------
# Build phase, as the fine-grained steps b1..b4.
# ---------------------------------------------------------------------------

def build_b1(key: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """(b1) compute hash bucket number."""
    return bucket_of(key, num_buckets)


def build_b2_order(bkt: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """(b2) bucket-header placement: stable (bucket, key) order, with keys
    compared as uint32 (two stable sorts, as in the JAX package)."""
    order = torch.sort(_u32(key), stable=True).indices
    return order[torch.sort(bkt[order], stable=True).indices]


def build_b3_keylists(sbkt: torch.Tensor, skey: torch.Tensor,
                      num_buckets: int):
    """(b3) create key headers: boundary flags over the sorted tuples."""
    dev = skey.device
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       (sbkt[1:] != sbkt[:-1]) | (skey[1:] != skey[:-1])])
    first = first[:skey.shape[0]]
    first_i = first.to(torch.int32)
    key_id = (_cumsum32(first_i) - 1).to(torch.int64)  # per-tuple key entry
    num_keys = first_i.sum(dtype=torch.int32)
    n = skey.shape[0]
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    ukeys = torch.full((n,), INVALID, dtype=torch.int32, device=dev)
    ukeys[key_id] = skey  # equal keys share a key_id: any writer wins
    key_rid_start = torch.full((n,), n, dtype=torch.int32, device=dev) \
        .scatter_reduce(0, key_id, iota, "amin", include_self=True)
    key_rid_count = _segment_sum(torch.ones_like(first_i), key_id, n)
    # Bucket headers count unique keys (= first flags) per bucket.
    bucket_key_count = _segment_sum(first_i, sbkt.to(torch.int64),
                                    num_buckets)
    bucket_key_start = _cumsum32(bucket_key_count) - bucket_key_count
    return (ukeys, key_rid_start, key_rid_count, bucket_key_start,
            bucket_key_count, num_keys)


def build_b4_ridlists(rid: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """(b4) insert record ids into the rid lists (gather in sorted order)."""
    return rid[order]


def table_from_buckets(rel: Relation, bkt: torch.Tensor,
                       num_buckets: int) -> HashTable:
    """b2 -> b3 -> b4 over precomputed bucket ids."""
    order = build_b2_order(bkt, rel.key)
    sbkt, skey = bkt[order], rel.key[order]
    (ukeys, key_rid_start, key_rid_count, bucket_key_start, bucket_key_count,
     num_keys) = build_b3_keylists(sbkt, skey, num_buckets)
    rids = build_b4_ridlists(rel.rid, order)
    return HashTable(bucket_key_start, bucket_key_count, ukeys, key_rid_start,
                     key_rid_count, rids, skey, num_keys)


def build_hash_table(rel: Relation, num_buckets: int) -> HashTable:
    """Full build phase: b1 -> b2 -> b3 -> b4."""
    return table_from_buckets(rel, build_b1(rel.key, num_buckets),
                              num_buckets)


def merge_hash_tables(parts: list[HashTable], num_buckets: int) -> HashTable:
    """Merge partial hash tables (the paper's DD merge step, Fig. 3):
    concatenate the sorted tuple streams and rebuild the CSR structure."""
    rid = torch.cat([p.rids for p in parts])
    key = torch.cat([p.skeys for p in parts])
    return build_hash_table(Relation(rid, key), num_buckets)


# ---------------------------------------------------------------------------
# Probe phase, as the fine-grained steps p1..p4.
# ---------------------------------------------------------------------------

def probe_p1(key: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """(p1) compute hash bucket number."""
    return bucket_of(key, num_buckets)


def probe_p2(table: HashTable, bkt: torch.Tensor):
    """(p2) visit the hash bucket header: one random gather per tuple."""
    return table.bucket_key_start[bkt], table.bucket_key_count[bkt]


def probe_p3(table: HashTable, key: torch.Tensor, kstart: torch.Tensor,
             kcount: torch.Tensor):
    """(p3) search the bucket's key list: a binary search with a fixed
    ``n.bit_length() + 1`` iterations and uint32 comparisons.  Returns the
    matching key-entry index (or -1) and its rid count."""
    n = table.ukeys.shape[0]
    iters = max(1, int(n).bit_length() + 1)
    lo = kstart
    hi = kstart + kcount
    target = _u32(key)
    ukeys_u = _u32(table.ukeys)
    for _ in range(iters):
        mid = (lo + hi) >> 1
        mid_key = ukeys_u[mid.clamp(0, n - 1)]
        go_right = (mid_key < target) & (lo < hi)
        new_lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right | (lo >= hi), hi, mid)
        lo = new_lo
    pos = lo.clamp(0, n - 1)
    found = (lo < kstart + kcount) & (table.ukeys[pos] == key)
    entry = torch.where(found, pos, torch.full_like(pos, INVALID))
    nmatch = torch.where(found, table.key_rid_count[pos],
                         torch.zeros_like(pos))
    return entry, nmatch


def probe_p4(table: HashTable, probe_rid: torch.Tensor, entry: torch.Tensor,
             nmatch: torch.Tensor, max_out: int) -> JoinResult:
    """(p4) visit matching build tuples and produce output pairs.

    Per-tuple match counts -> inclusive scan -> ``searchsorted`` expansion
    into a ``max_out``-slot result; overflow is truncated and reported via
    ``count``.
    """
    dev = probe_rid.device
    n = probe_rid.shape[0]
    if n == 0:
        empty = torch.full((max_out,), INVALID, dtype=torch.int32, device=dev)
        return JoinResult(empty, empty.clone(),
                          torch.zeros((), dtype=torch.int32, device=dev))
    offs = _cumsum32(nmatch)
    total = offs[-1]
    starts = offs - nmatch
    out_idx = torch.arange(max_out, dtype=torch.int32, device=dev)
    src = torch.searchsorted(offs, out_idx, right=True).to(torch.int32)
    count = torch.clamp(total, max=max_out).to(torch.int32)
    valid = out_idx < count
    src_c = src.clamp(0, n - 1)
    j = out_idx - starts[src_c]
    cap = table.rids.shape[0]
    bpos = (table.key_rid_start[entry[src_c].clamp(0, cap - 1)] + j) \
        .clamp(0, cap - 1)
    out_build = torch.where(valid, table.rids[bpos], INVALID)
    out_probe = torch.where(valid, probe_rid[src_c], INVALID)
    return JoinResult(out_probe.to(torch.int32), out_build.to(torch.int32),
                      count)


def probe_hash_table(rel: Relation, table: HashTable,
                     max_out: int) -> JoinResult:
    """Full probe phase: p1, then p2 -> p3 -> p4 as ``csr_probe_join``
    (the CSR lookup and expand kernels on a CUDA device, these steps on
    the CPU)."""
    bkt = probe_p1(rel.key, table.num_buckets)
    return csr_probe_join(table, bkt, rel.key, rel.rid, max_out)


# ---------------------------------------------------------------------------
# Oracle (NumPy, vectorized).
# ---------------------------------------------------------------------------

def join_oracle(build: Relation, probe: Relation) -> np.ndarray:
    """Sort-merge oracle: all matching (probe_rid, build_rid) pairs, sorted.

    The same pairs as ``repro.core.hash_table.join_oracle``; the per-match
    loop there is written here as repeat + gather so it runs at 2^24.
    """
    bk = build.key.cpu().numpy()
    br = build.rid.cpu().numpy()
    pk = probe.key.cpu().numpy()
    pr = probe.rid.cpu().numpy()
    order_b = np.argsort(bk, kind="stable")
    bk, br = bk[order_b], br[order_b]
    # Searched in key order, which keeps the searches cache-friendly.
    order_p = np.argsort(pk)
    lo = np.empty(pk.shape[0], dtype=np.int64)
    hi = np.empty(pk.shape[0], dtype=np.int64)
    lo[order_p] = np.searchsorted(bk, pk[order_p], side="left")
    hi[order_p] = np.searchsorted(bk, pk[order_p], side="right")
    counts = hi - lo
    rows = np.repeat(np.arange(pk.shape[0]), counts)
    first = np.cumsum(counts) - counts
    within = np.arange(rows.shape[0]) - first[rows]
    out = np.empty((rows.shape[0], 2), dtype=np.int64)
    out[:, 0] = pr[rows]
    out[:, 1] = br[lo[rows] + within]
    return sort_pairs(out)


def sort_pairs(pairs: np.ndarray) -> np.ndarray:
    """(n, 2) pairs of int32 values sorted by (first, second).

    The order of ``np.lexsort((pairs[:, 1], pairs[:, 0]))``, from one sort
    of a combined int64 key: an order of magnitude faster at 2^24 pairs.
    """
    key = pairs[:, 0].astype(np.int64) * (1 << 32) + \
        (pairs[:, 1].astype(np.int64) + (1 << 31))
    key.sort()
    out = np.stack([key >> 32, (key & 0xFFFFFFFF) - (1 << 31)], axis=1)
    return out.astype(pairs.dtype, copy=False)
