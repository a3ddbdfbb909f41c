"""Port parity: the CSR hash table, build b1..b4 and probe p1..p4
(repro_torch.core.hash_table against repro.core.hash_table).  Every
HashTable field and the whole JoinResult match bit for bit."""
import jax
import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
from repro.core import hash_table as jht
from repro.core import shj as jshj
from repro_torch.core import hash_table as tht
from repro_torch.core import interop
from repro_torch.core import shj as tshj

from _torch_parity import assert_same, relation


def _build_side(rng, n=2048, key_range=700):
    keys = rng.integers(0, key_range, n)
    keys[-16:] = -2       # the CoProcessor's build pad sentinel
    keys[:4] = [2**31 - 1, -7, 0, 5]
    return relation(keys, rng.permutation(n))


def _probe_side(rng, n=3000, key_range=800):
    keys = rng.integers(0, key_range, n)
    keys[-16:] = -3       # the probe pad sentinel
    keys[:3] = [2**31 - 1, -7, -2]
    return relation(keys)


@pytest.mark.parametrize("num_buckets", [1, 16, 512, 4096])
def test_build_matches_every_field(num_buckets, rng):
    jb, tb = _build_side(rng)
    want = jc.build_hash_table(jb, num_buckets)
    got = tc.build_hash_table(tb, num_buckets)
    assert_same(want, got)
    assert got.num_buckets == num_buckets and got.capacity == tb.size


@pytest.mark.parametrize("max_out", [1, 100, 20000])
@pytest.mark.parametrize("num_buckets", [16, 1024])
def test_probe_matches_whole_result(num_buckets, max_out, rng):
    jb, tb = _build_side(rng)
    jp, tp = _probe_side(rng)
    jt = jc.build_hash_table(jb, num_buckets)
    tt = tc.build_hash_table(tb, num_buckets)
    want = jc.probe_hash_table(jp, jt, max_out)
    got = tc.probe_hash_table(tp, tt, max_out)
    assert_same(want, got)


def test_probe_steps_match(rng):
    jb, tb = _build_side(rng)
    jp, tp = _probe_side(rng)
    jt = jc.build_hash_table(jb, 256)
    tt = interop.from_numpy(tc.HashTable, jax.tree.leaves(jt), device="cpu")
    jbk, tbk = jht.probe_p1(jp.key, 256), tht.probe_p1(tp.key, 256)
    assert_same(jbk, [tbk])
    jks, tks = jht.probe_p2(jt, jbk), tht.probe_p2(tt, tbk)
    assert_same(jks, tks)
    jen, ten = jht.probe_p3(jt, jp.key, *jks), tht.probe_p3(tt, tp.key, *tks)
    assert_same(jen, ten)


def test_build_steps_match(rng):
    jb, tb = _build_side(rng)
    jbk, tbk = jht.build_b1(jb.key, 64), tht.build_b1(tb.key, 64)
    assert_same(jbk, [tbk])
    jo, to = jht.build_b2_order(jbk, jb.key), tht.build_b2_order(tbk, tb.key)
    assert_same(jo, [to])
    assert_same(jht.build_b3_keylists(jbk[jo], jb.key[jo], 64),
                tht.build_b3_keylists(tbk[to], tb.key[to], 64))


def test_merge_matches(rng):
    jb, tb = _build_side(rng)
    parts_j = [jc.build_hash_table(jb.take(0, 700), 128),
               jc.build_hash_table(jb.take(700, 2048), 128)]
    parts_t = [tc.build_hash_table(tb.take(0, 700), 128),
               tc.build_hash_table(tb.take(700, 2048), 128)]
    assert_same(jc.merge_hash_tables(parts_j, 128),
                tc.merge_hash_tables(parts_t, 128))


@pytest.mark.parametrize("skew", [0, 25])
def test_shj_join_and_oracle_match(skew, rng):
    if skew:
        jb = jc.skewed_relation(4096, s_percent=skew, seed=5)
        tb = tc.skewed_relation(4096, s_percent=skew, seed=5, device="cpu")
    else:
        jb = jc.unique_relation(4096, seed=5)
        tb = tc.unique_relation(4096, seed=5, device="cpu")
    jp = jc.uniform_relation(4096, seed=6)
    tp = tc.uniform_relation(4096, seed=6, device="cpu")
    exp = jc.join_oracle(jb, jp)
    got_oracle = tc.join_oracle(tb, tp)
    assert got_oracle.dtype == exp.dtype and np.array_equal(exp, got_oracle)
    mo = 2 * 4096 + len(exp)
    want = jc.shj_join(jb, jp, num_buckets=1024, max_out=mo)
    got = tc.shj_join(tb, tp, num_buckets=1024, max_out=mo)
    assert_same(want, got)
    assert np.array_equal(got.valid_pairs(), exp)


def test_series_steps_match(rng):
    jb, tb = _build_side(rng, n=1024)
    shared = {"num_buckets": 128}
    ji = {"rid": jb.rid, "key": jb.key}
    ti = {"rid": tb.rid, "key": tb.key}
    for js, ts in zip(jshj.BUILD_SERIES.steps, tshj.BUILD_SERIES.steps):
        ji, jsh = js.apply(shared, ji)
        ti, tsh = ts.apply(shared, ti)
        assert sorted(ji) == sorted(ti) and sorted(jsh) == sorted(tsh)
        assert_same([ji[k] for k in sorted(ji)], [ti[k] for k in sorted(ti)])
        assert_same([jsh[k] for k in sorted(jsh)],
                    [tsh[k] for k in sorted(tsh)])
    jt, tt = jsh["partial_tables"][0], tsh["partial_tables"][0]
    jp, tp = _probe_side(rng, n=1500)
    shared_j = {"table": jt, "max_out": 4000}
    shared_t = {"table": tt, "max_out": 4000}
    ji = {"rid": jp.rid, "key": jp.key}
    ti = {"rid": tp.rid, "key": tp.key}
    for js, ts in zip(jshj.PROBE_SERIES.steps, tshj.PROBE_SERIES.steps):
        ji, jsh = js.apply(shared_j, ji)
        ti, tsh = ts.apply(shared_t, ti)
        assert_same([ji[k] for k in sorted(ji)], [ti[k] for k in sorted(ti)])
    assert_same(jsh["results"][0], tsh["results"][0])


def test_concat_results_matches(rng):
    jb, tb = _build_side(rng)
    jp, tp = _probe_side(rng)
    jt, tt = jc.build_hash_table(jb, 128), tc.build_hash_table(tb, 128)
    jparts = [jc.probe_hash_table(jp.take(0, 1000), jt, 3000),
              jc.probe_hash_table(jp.take(1000, 3000), jt, 5000)]
    tparts = [tc.probe_hash_table(tp.take(0, 1000), tt, 3000),
              tc.probe_hash_table(tp.take(1000, 3000), tt, 5000)]
    for mo in (10, 7000):
        assert_same(jshj.concat_results(jparts, mo),
                    tshj.concat_results(tparts, mo))


def test_interop_round_trip(rng):
    jb, _ = _build_side(rng)
    jt = jc.build_hash_table(jb, 64)
    tt = interop.from_numpy(tc.HashTable, jax.tree.leaves(jt), device="cpu")
    assert_same(jt, tt)
    assert all(isinstance(t, torch.Tensor) and t.dtype == torch.int32
               for t in (tt.rids, tt.num_keys))
    parts = jc.radix_partition_scheduled(jb, schedule=(3,))
    tparts = interop.from_numpy(tc.Partitions, jax.tree.leaves(parts),
                                 device="cpu")
    assert_same(parts, tparts)
    with pytest.raises(ValueError):
        interop.from_numpy(tc.JoinResult, jax.tree.leaves(parts),
                           device="cpu")


def test_default_num_buckets_matches():
    for n in (0, 1, 100, 4096, 1 << 24):
        assert tc.default_num_buckets(n) == jc.default_num_buckets(n)


def test_interop_defaults_to_the_card(monkeypatch):
    """Without ``device`` the conversions go to the card, and raise on a
    host that has none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rids = np.arange(8, dtype=np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.from_numpy(tc.Relation, [rids, rids])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.lm_params_from_numpy(None, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.lm_cache_from_numpy(None, {"unit": {}})
    rel = interop.from_numpy(tc.Relation, [rids, rids], device="cpu")
    assert rel.rid.device.type == "cpu"
