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


INT32_MIN = -2**31


def _chain_links(rng, sizes, bad):
    """Links of a chain over a column of ``sizes[0]`` rows: link k indexes
    the output of link k-1 (``sizes[k]`` rows); ``bad`` entries are out of
    range on the high side (n, n + 5) or wrap (-n ... -1)."""
    links = []
    for k in range(1, len(sizes)):
        n = sizes[k - 1]
        link = rng.integers(0, n, sizes[k])
        if bad:
            link[:6] = [-n, -1, n, n + 5, -n - 1, -(n // 2) - 1]
        links.append(link.astype(np.int32))
    return links


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5])
def test_index_chain_out_of_range_links(depth):
    """Out-of-range links follow ``jnp.take``'s fill mode at every depth
    (past the depth cap the chain flattens, and still does)."""
    rng = np.random.default_rng(depth)
    sizes = [64, 48, 40, 32, 24, 16][:depth + 1]
    col = rng.integers(-1000, 1000, 64).astype(np.int32)
    jch, tch = jc.relation.IndexChain(), IndexChain()
    for link in _chain_links(rng, sizes, bad=True):
        jch = jch.extend(jnp.asarray(link))
        tch = tch.extend(torch.from_numpy(link))
    want = np.asarray(jch.gather(jnp.asarray(col)))
    got = tch.gather(torch.from_numpy(col))
    assert got.dtype == torch.int32 and tch.depth == jch.depth
    assert np.array_equal(want, got.numpy())
    assert (want == INT32_MIN).any()
    # The column's own gather: the flat index goes out of range too.
    assert np.array_equal(np.asarray(jch.gather(jnp.asarray(col[:7]))),
                          tch.gather(torch.from_numpy(col[:7])).numpy())


def test_index_chain_fault_case():
    """The case that opened the fault: [19, 13, INT32_MIN], not a clamp."""
    col = np.arange(10, 20, dtype=np.int32)
    link = np.array([-1, 3, 12], np.int32)
    want = jc.relation.IndexChain((jnp.arange(10, dtype=jnp.int32),)) \
        .extend(jnp.asarray(link)).gather(jnp.asarray(col))
    got = IndexChain((torch.arange(10, dtype=torch.int32),)) \
        .extend(torch.from_numpy(link)).gather(torch.from_numpy(col))
    assert got.tolist() == np.asarray(want).tolist() == [19, 13, INT32_MIN]
    one = IndexChain((torch.from_numpy(link),)).gather(torch.from_numpy(col))
    assert one.tolist() == [19, 13, INT32_MIN]


@pytest.mark.parametrize("idx", [[5], [-1, -5, 0], [-6, 5, 9, 2],
                                 [4, 10, -1, -7]])
def test_relation_gather_out_of_range(idx):
    """Both columns read INT32_MIN at rows out of range; -n..-1 wrap."""
    jr, tr = relation(np.arange(100, 105), rids=np.arange(5) + 7)
    idx = np.asarray(idx, np.int32)
    assert_same(jr.gather(jnp.asarray(idx)), tr.gather(torch.from_numpy(idx)))
    assert_same(jr.gather(jnp.asarray(idx)), tr.gather(idx.tolist()))


def test_take_from_an_empty_column_matches():
    """An empty column: a non-empty take raises IndexError in both
    packages; an empty take gives an empty column."""
    jr, tr = relation(np.zeros(0, np.int32))
    for idx in ([0], [-1, 3]):
        with pytest.raises(IndexError):
            jr.gather(jnp.asarray(idx, jnp.int32))
        with pytest.raises(IndexError):
            tr.gather(idx)
        with pytest.raises(IndexError):
            jc.relation.IndexChain((jnp.asarray(idx, jnp.int32),)) \
                .gather(jnp.zeros(0, jnp.int32))
        with pytest.raises(IndexError):
            IndexChain((torch.tensor(idx, dtype=torch.int32),)) \
                .gather(torch.zeros(0, dtype=torch.int32))
    empty = np.zeros(0, np.int32)
    assert_same(jr.gather(jnp.asarray(empty)), tr.gather(
        torch.from_numpy(empty)))
    got = IndexChain((torch.from_numpy(empty),)).gather(
        torch.zeros(0, dtype=torch.int32))
    assert got.shape == (0,) and got.dtype == torch.int32


def test_take_fill_values_by_dtype():
    """``jnp.take``'s fill for other column types: NaN, the unsigned max,
    True, the int64 min."""
    from repro_torch.core.relation import take_fill
    idx = np.array([-1, 7, 0], np.int32)
    for dt, jt in ((torch.float32, jnp.float32), (torch.uint8, jnp.uint8),
                   (torch.bool, jnp.bool_)):
        col = np.array([1, 0, 1], np.int32)
        want = np.asarray(jnp.take(jnp.asarray(col).astype(jt),
                                   jnp.asarray(idx), axis=0))
        got = take_fill(torch.from_numpy(col).to(dt), torch.from_numpy(idx))
        assert np.array_equal(want, got.numpy(), equal_nan=dt.is_floating_point)
    got = take_fill(torch.arange(3), torch.tensor([3]))
    assert got.tolist() == [torch.iinfo(torch.int64).min]
    rows = take_fill(torch.ones(3, 2), torch.tensor([1, 5]))
    assert rows[0].tolist() == [1.0, 1.0] and rows[1].isnan().all()


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.uniform_relation(16, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.resolve_device("cuda:0")
    assert tc.resolve_device("cpu") == torch.device("cpu")
