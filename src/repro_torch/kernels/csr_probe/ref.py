"""The cases the CSR probe kernels are held to against the plain steps
p2 -> p3 -> p4 (``CASES``, made by ``csr_case``), and the PHJ join
phase's probe at full size (``phj_probe_inputs``), uniform, skewed on
the probe side (``zipf_pair``) or on the build side (``zipf_build_pair``),
for the card tests and the timings.
"""
from __future__ import annotations

import numpy as np
import torch

HEAVY_RANKS = (300, 1000, 3000)

CASES = ("empty_probe", "max_out_zero", "truncated", "no_key_found",
         "hot_key_4096", "negative_keys_and_pads", "single_key_buckets",
         "many_key_bucket")


def _buckets(key: np.ndarray, mode: str, num_buckets: int) -> np.ndarray:
    """Bucket ids as a function of the key, so build and probe agree."""
    if mode == "one":       # every key of [0, B) alone in its bucket
        return key.astype(np.int32)
    if mode == "many":      # half the keys crowd bucket 0
        k = key.astype(np.int64) & 0xFFFFFFFF
        return np.where(k % 2 == 0, 0, 1 + k % (num_buckets - 1)) \
            .astype(np.int32)
    from repro_torch.core.phj import partition_bucket_ids

    bits = num_buckets.bit_length() - 1
    return partition_bucket_ids(torch.from_numpy(key), total_bits=bits - 1,
                                shj_bits=1).numpy()


def csr_case(name: str, *, seed: int = 0):
    """One case: ``(build_rid, build_key, build_bkt, num_buckets,
    probe_rid, probe_key, probe_bkt, max_out)`` as NumPy int32 arrays
    (and ints), made from ``seed``.  Build the table with
    ``table_from_buckets(Relation(build_rid, build_key), build_bkt,
    num_buckets)``."""
    rng = np.random.default_rng(seed)
    nb, mode = 256, "hash"
    n_b, n_p = 2000, 3000
    bk = rng.integers(0, 1500, n_b).astype(np.int32)
    pk = rng.integers(0, 1500, n_p).astype(np.int32)
    max_out = None
    if name == "empty_probe":
        pk = pk[:0]
        max_out = 100
    elif name == "max_out_zero":
        max_out = 0
    elif name == "no_key_found":
        bk, pk = 2 * bk, 2 * pk + 1
    elif name == "hot_key_4096":
        bk = np.concatenate([np.where(bk == 77, 78, bk).astype(np.int32),
                             np.full(4096, 77, dtype=np.int32)])
        pk[rng.permutation(n_p)[:7]] = 77
    elif name == "negative_keys_and_pads":
        special = np.array([-1, -2, -3, -7, -2**31, 2**31 - 1, 0, 2**31 - 2],
                           dtype=np.int32)
        bk = np.concatenate([rng.integers(-60, 60, n_b).astype(np.int32),
                             np.full(64, -2, np.int32), special])
        pk = np.concatenate([rng.integers(-70, 70, n_p).astype(np.int32),
                             np.full(64, -3, np.int32), special])
        nb = 16
    elif name == "single_key_buckets":
        nb, mode = 1024, "one"
        bk = rng.permutation(nb)[:700].astype(np.int32)
        bk = np.concatenate([bk, bk[:50]])     # some keys with two rids
        pk = rng.integers(0, nb, n_p).astype(np.int32)
    elif name == "many_key_bucket":
        mode = "many"
        bk = rng.integers(-3000, 3000, n_b).astype(np.int32)
        pk = rng.integers(-3100, 3100, n_p).astype(np.int32)
    elif name != "truncated":
        raise ValueError(f"unknown case {name!r}: one of {CASES}")
    bkt, pbkt = _buckets(bk, mode, nb), _buckets(pk, mode, nb)
    if max_out is None:
        keys, counts = np.unique(bk, return_counts=True)
        at = np.searchsorted(keys, pk).clip(max=keys.shape[0] - 1)
        total = int(counts[at][keys[at] == pk].sum())
        max_out = total // 3 if name == "truncated" else total + 37
    brid = rng.permutation(bk.shape[0]).astype(np.int32)
    prid = (rng.permutation(pk.shape[0]) + 10**6).astype(np.int32)
    return brid, bk, bkt, nb, prid, pk, pbkt, max_out


def zipf_pair(n: int, *, seed: int = 7):
    """Keys of a skewed join of ``n`` x ``n`` tuples, as NumPy int32: S's
    keys are numpy's ``zipf(1.5)`` ranks (clipped to ``n``) over a fixed
    permutation of ``[0, n)``, R's are uniform in ``[0, n)`` but for its
    first ``4096 * len(HEAVY_RANKS)`` tuples, which hold S's keys at
    ``HEAVY_RANKS``, 4096 tuples each: a probe of such a key matches
    thousands of build tuples.  Returns ``(build_key, probe_key)``."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n).astype(np.int32)
    probe = perm[np.minimum(rng.zipf(1.5, n), n) - 1]
    build = rng.integers(0, n, n).astype(np.int32)
    for i, r in enumerate(HEAVY_RANKS):
        build[i * 4096:(i + 1) * 4096] = perm[r - 1]
    return build, probe


def zipf_build_pair(n: int, *, s: float = 1.0, seed: int = 7):
    """Keys of a join of ``n`` x ``n`` tuples skewed on the build side, as
    NumPy int32: R's keys are Zipf(``s``) ranks over a permutation of
    ``[0, n)`` (inverse transform of the float64 running sum of k^-s), S
    holds each key of ``[0, n)`` once, shuffled.  At ``n`` = 2^24 and s =
    1 the hottest key has about 975k build tuples, as in the
    ``phj_zipf_16m.build_skew`` cell.  Returns ``(build_key,
    probe_key)``."""
    rng = np.random.default_rng(seed)
    cdf = np.cumsum(np.arange(1, n + 1, dtype=np.float64) ** -s)
    rank = np.searchsorted(cdf, rng.random(n) * cdf[-1], side="right")
    perm = rng.permutation(n).astype(np.int32)
    return perm[np.minimum(rank, n - 1)], rng.permutation(n).astype(np.int32)


def phj_probe_inputs(n: int, kind: str, schedule, *, device):
    """The PHJ join phase's probe of R and S, ``n`` tuples each, on
    ``device``: R and S partitioned by ``schedule``, the table
    ``partitioned_join`` builds on R (``phj_bucket_count`` buckets a
    partition) and S's bucket ids.  R and S are uniform (seeds 1 and 2)
    for ``kind`` "uniform", ``zipf_pair``'s keys with the row numbers as
    rids for "zipf", ``zipf_build_pair``'s for "build_skew".  Returns
    ``(R, S, table, pbkt)``."""
    from repro_torch.core import (Relation, radix_partition_scheduled,
                                  uniform_relation)
    from repro_torch.core.hash_table import table_from_buckets
    from repro_torch.core.phj import partition_bucket_ids, phj_bucket_count

    if kind == "uniform":
        build = uniform_relation(n, seed=1, device=device)
        probe = uniform_relation(n, seed=2, device=device)
    elif kind in ("zipf", "build_skew"):
        rid = torch.arange(n, dtype=torch.int32, device=device)
        keys = zipf_pair(n) if kind == "zipf" else zipf_build_pair(n)
        build, probe = (Relation(rid, torch.from_numpy(k).to(device))
                        for k in keys)
    else:
        raise ValueError(f"unknown kind {kind!r}: uniform, zipf or "
                         f"build_skew")
    bits = sum(schedule)
    shj = phj_bucket_count(n, bits).bit_length() - 1
    r = radix_partition_scheduled(build, schedule=schedule).rel
    s = radix_partition_scheduled(probe, schedule=schedule).rel
    table = table_from_buckets(
        r, partition_bucket_ids(r.key, total_bits=bits, shj_bits=shj),
        1 << (bits + shj))
    return r, s, table, partition_bucket_ids(s.key, total_bits=bits,
                                             shj_bits=shj)
