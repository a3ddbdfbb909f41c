"""The CSR probe of the hash join on the CPU: its wrappers, and the
probes that call them (``partitioned_join``, ``probe_hash_table``, the
variant probes), are the plain steps p2 -> p3 -> p4 bit for bit on the
edge cases the card tests hold the kernels to, and the PHJ join through
it still matches the JAX package."""
import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
from repro_torch.core import hash_table as ht
from repro_torch.core.phj import partitioned_join
from repro_torch.kernels import launch_counts
from repro_torch.kernels.csr_probe import (EXPAND_COUNTERS, HEAVY, SPLIT,
                                           csr_expand, csr_lookup,
                                           csr_probe_join, ref)
from repro_torch.kernels.csr_probe.csr_probe import count_expand_plain
from repro_torch.obs.trace import Tracer
from repro_torch.ops import join_variants as jv

from _torch_parity import assert_same, relation


def _case(name):
    brid, bk, bkt, nb, prid, pk, pbkt, mo = ref.csr_case(name)
    t = torch.from_numpy
    table = ht.table_from_buckets(tc.Relation(t(brid), t(bk)), t(bkt), nb)
    return table, t(pbkt), t(pk), t(prid), mo


def _plain(table, pbkt, pk, prid, mo):
    kstart, kcount = ht.probe_p2(table, pbkt)
    entry, nmatch = ht.probe_p3(table, pk, kstart, kcount)
    return entry, nmatch, ht.probe_p4(table, prid, entry, nmatch, mo)


def _same(got: ht.JoinResult, want: ht.JoinResult) -> None:
    for f in ("probe_rid", "build_rid", "count"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype == torch.int32, f
        assert torch.equal(g, w), f


@pytest.mark.parametrize("name", ref.CASES)
def test_cpu_wrappers_are_the_plain_steps(name):
    table, pbkt, pk, prid, mo = _case(name)
    entry, nmatch, want = _plain(table, pbkt, pk, prid, mo)
    got_entry, got_nmatch = csr_lookup(table, pbkt, pk)
    assert torch.equal(got_entry, entry) and torch.equal(got_nmatch, nmatch)
    _same(csr_expand(table, prid, entry, nmatch, mo), want)
    _same(csr_probe_join(table, pbkt, pk, prid, mo), want)


@pytest.mark.parametrize("name", ref.CASES)
def test_cpu_table_probes_are_the_plain_steps(name):
    """``probe_hash_table`` and the semi / anti / left-outer probes over a
    table from ``build_hash_table`` equal p1 -> p2 -> p3 and their own
    emission, bit for bit, and launch nothing."""
    brid, bk, _, nb, prid, pk, _, mo = ref.csr_case(name)
    t = torch.from_numpy
    table = ht.build_hash_table(tc.Relation(t(brid), t(bk)), nb)
    rel = tc.Relation(t(prid), t(pk))
    bkt = ht.probe_p1(rel.key, nb)
    entry, nmatch, want = _plain(table, bkt, rel.key, rel.rid, mo)
    valid = rel.rid != ht.INVALID
    before = launch_counts()["csr_probe"]
    _same(ht.probe_hash_table(rel, table, mo), want)
    for kind, plain in (
            ("inner", want),
            ("semi", jv._emit_flagged(rel.rid, (nmatch > 0) & valid, mo)),
            ("anti", jv._emit_flagged(rel.rid, (nmatch == 0) & valid, mo)),
            ("left_outer", jv._probe_p4_outer(table, rel.rid, entry, nmatch,
                                              valid, mo))):
        _same(jv.probe_hash_table_variant(rel, table, mo, kind), plain)
    assert launch_counts()["csr_probe"] == before


@pytest.mark.parametrize("name", ref.CASES)
def test_cases_hold_what_they_name(name):
    table, pbkt, pk, prid, mo = _case(name)
    entry, nmatch, res = _plain(table, pbkt, pk, prid, mo)
    total, count = int(nmatch.sum()), int(res.count)
    kcount = table.bucket_key_count
    check = {
        "empty_probe": lambda: pk.numel() == 0 and mo > 0 and count == 0,
        "max_out_zero": lambda: mo == 0 and total > 0
        and res.probe_rid.numel() == 0,
        "truncated": lambda: 0 < mo < total and count == mo,
        "no_key_found": lambda: total == 0 and bool((entry == -1).all())
        and mo > 0,
        "hot_key_4096": lambda: int(nmatch.max()) == 4096
        and count == total < mo,
        "negative_keys_and_pads": lambda: bool((pk == -3).any())
        and bool((table.ukeys == -2).any()) and 0 < count == total < mo
        and bool((entry[pk < 0] >= 0).any()),
        "single_key_buckets": lambda: int(kcount.max()) == 1
        and 0 < count == total,
        "many_key_bucket": lambda: int(kcount.max()) > 16
        and int(kcount[1:].max()) <= 16 and 0 < count == total,
    }[name]
    assert check()
    if 0 < count < mo:
        assert bool((res.probe_rid[count:] == ht.INVALID).all())


@pytest.mark.parametrize("sched", [(3, 2), (6,)])
def test_phj_join_over_hot_key_matches_jax(sched):
    """A key with 4096 build tuples, probed 5 times, through the whole
    PHJ join on the CPU (the plain steps; the card tests hold the kernels
    to them): the JoinResult equals the JAX package's and the oracle."""
    rng = np.random.default_rng(5)
    bk = np.concatenate([rng.integers(0, 3000, 4000), np.full(4096, 9)])
    pk = rng.integers(0, 3000, 4096)
    pk[rng.permutation(4096)[:5]] = 9
    (jb, tb), (jp, tp) = relation(bk), relation(pk)
    exp = jc.join_oracle(jb, jp)
    mo = len(exp) + 64
    want = jc.phj_join(jb, jp, schedule=sched, max_out=mo)
    got = tc.phj_join(tb, tp, schedule=sched, max_out=mo)
    assert_same(want, got)
    assert np.array_equal(got.valid_pairs(), exp)


def test_cpu_partitioned_join_launches_no_kernel():
    b = tc.uniform_relation(4096, seed=1, device="cpu")
    p = tc.uniform_relation(4096, seed=2, device="cpu")
    before = launch_counts()["csr_probe"]
    res = partitioned_join(b, p, total_bits=3, shj_bits=2, max_out=10000)
    assert launch_counts()["csr_probe"] == before
    assert np.array_equal(res.valid_pairs(), tc.join_oracle(b, p))


def _expected_counts(nmatch) -> list[int]:
    m = nmatch.numpy().astype(np.int64)
    return [int(m.sum()), int(m[m > HEAVY].sum()), int(m.max(initial=0)),
            int(m[m > SPLIT].sum())]


@pytest.mark.parametrize("name", ref.CASES)
def test_cpu_expand_counts_pairs_heavy_pairs_and_longest_list(name):
    """``csr_expand``'s counters on the CPU: the pairs matched, those of
    rid lists longer than ``HEAVY``, the longest list, those of lists
    longer than ``SPLIT``; added to what the tensor holds (the longest
    raised), and the result unchanged."""
    table, pbkt, pk, prid, mo = _case(name)
    entry, nmatch, want = _plain(table, pbkt, pk, prid, mo)
    counters = torch.zeros(len(EXPAND_COUNTERS), dtype=torch.int64)
    _same(csr_expand(table, prid, entry, nmatch, mo, counters=counters),
          want)
    pairs, heavy, longest, split = _expected_counts(nmatch)
    assert counters.tolist() == [pairs, heavy, longest, split]
    csr_expand(table, prid, entry, nmatch, mo, counters=counters)
    assert counters.tolist() == [2 * pairs, 2 * heavy, longest, 2 * split]
    if name == "hot_key_4096":
        assert heavy >= 4096 and longest == 4096
        assert split == 4096 * int((nmatch == 4096).sum()) > 0
    else:
        assert split == 0


@pytest.mark.parametrize("m,split", [(SPLIT - 1, 0), (SPLIT, 0),
                                     (SPLIT + 1, SPLIT + 1),
                                     (1 << 20, 1 << 20)])
def test_cpu_split_pairs_count_lists_longer_than_split(m, split):
    """``split_pairs`` is 0 for lists of at most ``SPLIT`` rids and the
    list's length above it, beside lists of 0 to ``HEAVY`` + 1 rids."""
    nmatch = torch.tensor([0, 1, HEAVY, HEAVY + 1, m, 3], dtype=torch.int32)
    counters = torch.zeros(len(EXPAND_COUNTERS), dtype=torch.int64)
    count_expand_plain(nmatch, counters)
    assert dict(zip(EXPAND_COUNTERS, counters.tolist())) == {
        "pairs": 2 * HEAVY + 5 + m, "heavy_pairs": HEAVY + 1 + m,
        "warp_max_pairs": m, "split_pairs": split}


@pytest.mark.parametrize("bad", [
    torch.zeros(4, dtype=torch.int32),          # not int64
    torch.zeros(3, dtype=torch.int64),          # not four counts
    torch.zeros(8, dtype=torch.int64)[::2],     # not contiguous
])
def test_cpu_expand_rejects_bad_counters(bad):
    table, pbkt, pk, prid, mo = _case("hot_key_4096")
    entry, nmatch, _ = _plain(table, pbkt, pk, prid, mo)
    with pytest.raises(ValueError):
        csr_expand(table, prid, entry, nmatch, mo, counters=bad)


def test_traced_partitioned_join_spans_the_expand_with_its_counts():
    """``join.expand`` nests in ``join.probe`` and carries the counts of
    the probe's match counts; an untraced join records nothing and
    answers the same."""
    rng = np.random.default_rng(3)
    bk = np.concatenate([rng.integers(0, 3000, 4000), np.full(500, 5000)])
    pk = np.concatenate([rng.integers(0, 3000, 4000), [5000, 5000]])
    b, p = (tc.Relation(torch.arange(len(k), dtype=torch.int32),
                        torch.from_numpy(k.astype(np.int32)))
            for k in (bk, pk))
    tr = Tracer()
    kw = dict(total_bits=3, shj_bits=2, max_out=20000)
    res = partitioned_join(b, p, tracer=tr, **kw)
    spans = {s.name: s for s in tr.spans()}
    assert list(spans) == ["join.build", "join.expand", "join.probe"]
    probe, expand = spans["join.probe"], spans["join.expand"]
    assert probe.t0 <= expand.t0 <= expand.t1 <= probe.t1
    sbk = np.sort(bk)
    m = torch.from_numpy(np.searchsorted(sbk, pk, "right")
                         - np.searchsorted(sbk, pk, "left"))
    assert [expand.attrs[k] for k in EXPAND_COUNTERS] == _expected_counts(m)
    assert expand.attrs["warp_max_pairs"] == 500
    assert expand.attrs["pairs"] == int(res.count)
    _same(partitioned_join(b, p, **kw), res)
