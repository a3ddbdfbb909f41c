"""Port parity: relations, generators and hashes (repro_torch.core.relation
against repro.core.relation), bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
from repro_torch.core.relation import IndexChain

from _torch_parity import assert_same, relation

GENERATORS = {
    "uniform": lambda m, n, seed: m.uniform_relation(n, seed=seed),
    "uniform_range": lambda m, n, seed: m.uniform_relation(
        n, key_range=97, seed=seed),
    "unique": lambda m, n, seed: m.unique_relation(n, seed=seed),
    "low_skew": lambda m, n, seed: m.skewed_relation(n, s_percent=10,
                                                     seed=seed),
    "high_skew": lambda m, n, seed: m.skewed_relation(n, s_percent=25,
                                                      seed=seed),
}


def _cpu(fn):
    """A generator call on the port, on the CPU."""
    return lambda *a, **kw: fn(*a, **kw, device="cpu")


class _TorchCPU:
    uniform_relation = staticmethod(_cpu(tc.uniform_relation))
    unique_relation = staticmethod(_cpu(tc.unique_relation))
    skewed_relation = staticmethod(_cpu(tc.skewed_relation))


@pytest.mark.parametrize("n", [1, 1000, 8192])
@pytest.mark.parametrize("gen", list(GENERATORS))
def test_generators_match(gen, n):
    want = GENERATORS[gen](jc, n, 7)
    got = GENERATORS[gen](_TorchCPU, n, 7)
    assert_same(want, got)
    assert got.rid.dtype == torch.int32 and got.key.dtype == torch.int32
    assert got.size == n and got.nbytes == n * tc.relation.TUPLE_BYTES


@pytest.mark.parametrize("selectivity", [0.125, 0.5, 1.0])
def test_probe_with_selectivity_matches(selectivity):
    jb = jc.unique_relation(2048, seed=3)
    tb = tc.unique_relation(2048, seed=3, device="cpu")
    want = jc.probe_with_selectivity(jb, 4096, selectivity=selectivity,
                                     seed=4)
    got = tc.probe_with_selectivity(tb, 4096, selectivity=selectivity,
                                    seed=4)
    assert_same(want, got)
    assert got.device.type == "cpu"


def _keys(rng, n=4096):
    """Keys over the whole int32 range plus the negative pad sentinels."""
    keys = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64)
    keys[:8] = [-1, -2, -3, -7, 0, 1, 2**31 - 1, -2**31]
    return keys.astype(np.int32)


def test_fmix32_matches_uint32_hash(rng):
    keys = _keys(rng)
    want = np.asarray(jc.murmur3_fmix32(jnp.asarray(keys))).astype(np.int64)
    got = tc.murmur3_fmix32(torch.from_numpy(keys)).numpy()
    assert np.array_equal(want, got)


@pytest.mark.parametrize("num_buckets", [1, 4, 1024, 1 << 20])
def test_bucket_of_matches(num_buckets, rng):
    keys = _keys(rng)
    want = np.asarray(jc.bucket_of(jnp.asarray(keys), num_buckets))
    got = tc.bucket_of(torch.from_numpy(keys), num_buckets)
    assert got.dtype == torch.int32
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("shift,bits", [(0, 1), (0, 7), (7, 6), (13, 9),
                                        (16, 16), (31, 1)])
def test_radix_of_matches(shift, bits, rng):
    keys = _keys(rng)
    want = np.asarray(jc.radix_of(jnp.asarray(keys), shift=shift, bits=bits))
    got = tc.radix_of(torch.from_numpy(keys), shift=shift, bits=bits)
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("n", [0, 1, 2, 3, 1000, 1 << 24])
def test_next_pow2_matches(n):
    assert tc.relation.next_pow2(n) == jc.relation.next_pow2(n)


def test_take_and_gather(rng):
    jr, tr = relation(rng.integers(0, 50, 300))
    assert_same(jr.take(10, 90), tr.take(10, 90))
    idx = rng.integers(0, 300, 77)
    assert_same(jr.gather(jnp.asarray(idx)), tr.gather(torch.from_numpy(idx)))


def test_index_chain_matches(rng):
    col = rng.integers(0, 1000, 512).astype(np.int32)
    links = [rng.integers(0, 512, 400), rng.integers(0, 400, 300),
             rng.integers(0, 300, 200), rng.integers(0, 200, 100),
             rng.integers(0, 100, 50)]
    jch, tch = jc.relation.IndexChain(), IndexChain()
    for link in links:
        jch = jch.extend(jnp.asarray(link.astype(np.int32)))
        tch = tch.extend(torch.from_numpy(link.astype(np.int32)))
        assert jch.depth == tch.depth and jch.size == tch.size
        assert np.array_equal(np.asarray(jch.gather(jnp.asarray(col))),
                              tch.gather(torch.from_numpy(col)).numpy())
    assert IndexChain().gather(torch.arange(3)).tolist() == [0, 1, 2]


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.uniform_relation(16, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.resolve_device("cuda:0")
    assert tc.resolve_device("cpu") == torch.device("cpu")
