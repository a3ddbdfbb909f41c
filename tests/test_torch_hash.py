"""Port parity for kernels D (hash_bucket) and E (radix_hist): the plain
versions (what a CPU tensor runs) against the JAX package's Pallas kernels
in interpret mode and its jnp references, bit for bit, and the call sites
that route through them (bucket_of, radix_of, partition_n2)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
from repro.core.partition import partition_n2 as j_partition_n2
from repro.kernels.hash.hash import hash_bucket_pallas
from repro.kernels.hash.ref import hash_bucket_ref as j_hash_ref
from repro.kernels.partition_hist.partition_hist import radix_hist_pallas
from repro.kernels.partition_hist.ref import radix_hist_ref as j_hist_ref
from repro_torch.core.partition import partition_n2
from repro_torch.kernels.hash.ops import hash_bucket
from repro_torch.kernels.hash.ref import hash_bucket_ref
from repro_torch.kernels.partition_hist.ops import radix_hist
from repro_torch.kernels.partition_hist.partition_hist import \
    radix_hist_plain
from repro_torch.kernels.partition_hist.ref import (clustered_pids,
                                                    radix_hist_ref)

SIZES = [1, 2, 1 << 7, 1 << 13]


def _keys(n, seed):
    """Keys over the whole int32 range, with the negative pad sentinels."""
    keys = np.random.default_rng(seed).integers(-2**31, 2**31, n,
                                                dtype=np.int64)
    keys[:6] = [-1, -2, -3, -4, 2**31 - 1, -2**31]
    return keys.astype(np.int32)


def _eq(jax_arr, t: torch.Tensor):
    want = np.asarray(jax_arr)
    got = t.numpy()
    assert got.dtype == np.int32 and want.shape == got.shape
    assert np.array_equal(want.astype(np.int64), got.astype(np.int64))


@pytest.mark.parametrize("num_buckets", SIZES)
def test_hash_bucket_matches_pallas_and_ref(num_buckets):
    keys = _keys(2048, seed=num_buckets)
    got = hash_bucket(torch.from_numpy(keys), num_buckets=num_buckets)
    _eq(hash_bucket_pallas(jnp.asarray(keys), num_buckets=num_buckets,
                           interpret=True), got)
    _eq(j_hash_ref(jnp.asarray(keys), num_buckets=num_buckets), got)
    assert torch.equal(got, hash_bucket_ref(torch.from_numpy(keys),
                                            num_buckets=num_buckets))


@pytest.mark.parametrize("num_buckets", [1 << 13, 1 << 31])
def test_bucket_of_and_radix_of_route_through_hash_bucket(num_buckets):
    keys = _keys(5000, seed=7)      # ragged: the jnp reference side
    tk, jk = torch.from_numpy(keys), jnp.asarray(keys)
    _eq(jc.bucket_of(jk, num_buckets), tc.bucket_of(tk, num_buckets))
    bits = num_buckets.bit_length() - 1
    _eq(jc.radix_of(jk, shift=0, bits=bits),
        tc.radix_of(tk, shift=0, bits=bits))
    _eq(jc.radix_of(jk, shift=7, bits=6), tc.radix_of(tk, shift=7, bits=6))


@pytest.mark.parametrize("num_buckets", [0, 3, 1 << 32])
def test_hash_bucket_rejects_bad_bucket_counts(num_buckets):
    with pytest.raises(ValueError, match="power of two"):
        hash_bucket(torch.zeros(4, dtype=torch.int32),
                    num_buckets=num_buckets)


@pytest.mark.parametrize("num_parts", SIZES)
def test_radix_hist_matches_pallas_and_ref(num_parts):
    rng = np.random.default_rng(num_parts)
    pid = rng.integers(0, num_parts, 2048).astype(np.int32)
    got = radix_hist(torch.from_numpy(pid), num_parts=num_parts)
    _eq(radix_hist_pallas(jnp.asarray(pid), num_parts=num_parts,
                          interpret=True), got)
    _eq(j_hist_ref(jnp.asarray(pid), num_parts=num_parts), got)


@pytest.mark.parametrize("num_parts", SIZES)
def test_radix_hist_drops_out_of_range_pids(num_parts):
    """Pids -1 and >= P are not counted, as the JAX reference and the
    Pallas kernel drop them (the port's first ``radix_hist_ref`` raised on
    a negative pid and grew its output past P)."""
    rng = np.random.default_rng(num_parts + 1)
    pid = rng.integers(-3, num_parts + 3, 2048).astype(np.int32)
    pid[:3] = [-1, num_parts, 2**31 - 1]
    got = radix_hist_ref(torch.from_numpy(pid), num_parts=num_parts)
    assert got.shape == (num_parts,)
    _eq(radix_hist_pallas(jnp.asarray(pid), num_parts=num_parts,
                          interpret=True), got)
    _eq(j_hist_ref(jnp.asarray(pid), num_parts=num_parts), got)
    assert torch.equal(got, radix_hist(torch.from_numpy(pid),
                                       num_parts=num_parts))


@pytest.mark.parametrize("num_parts", SIZES)
def test_radix_hist_clustered_matches_pallas(num_parts):
    """Clustered pids (sorted runs, as a partitioned relation's final
    headers give kernel E) with -1, P and P + 1 inside the runs: the plain
    version against the Pallas kernel in interpret mode."""
    pid = clustered_pids(4096, num_parts, seed=num_parts)
    assert bool(((pid < 0) | (pid >= num_parts)).any())
    got = radix_hist_plain(pid, num_parts=num_parts)
    _eq(radix_hist_pallas(jnp.asarray(pid.numpy()), num_parts=num_parts,
                          interpret=True), got)
    _eq(j_hist_ref(jnp.asarray(pid.numpy()), num_parts=num_parts), got)


def test_radix_hist_fault_case():
    pid = np.array([0, 1, 5, -1, 3] + [0] * 1019, np.int32)
    got = radix_hist_ref(torch.from_numpy(pid), num_parts=4)
    assert got.tolist() == [1020, 1, 0, 1]
    _eq(j_hist_ref(jnp.asarray(pid), num_parts=4), got)
    _eq(radix_hist_pallas(jnp.asarray(pid), num_parts=4, interpret=True),
        got)


@pytest.mark.parametrize("num_parts", [(1 << 16) + 1, 1 << 17, 1 << 18])
def test_radix_hist_wide_matches_reference(num_parts):
    """Histograms wider than 2^16 bins, out-of-range pids dropped."""
    pid = np.random.default_rng(num_parts).integers(
        -3, num_parts + 3, 5000).astype(np.int32)
    _eq(j_hist_ref(jnp.asarray(pid), num_parts=num_parts),
        radix_hist(torch.from_numpy(pid), num_parts=num_parts))


def test_partition_n2_matches_reference():
    pid = np.random.default_rng(3).integers(-1, 70, 3000).astype(np.int32)
    want = j_partition_n2(jnp.asarray(pid), 64)
    got = partition_n2(torch.from_numpy(pid), 64)
    for w, g in zip(want, got):
        _eq(w, g)


@pytest.mark.parametrize("num_parts", [0, -1])
def test_radix_hist_rejects_bad_part_counts(num_parts):
    with pytest.raises(ValueError, match="num_parts"):
        radix_hist(torch.zeros(4, dtype=torch.int32), num_parts=num_parts)
