"""The port's Hopper kernels and main path on a CUDA card, against their
plain versions and the CPU path, bit for bit.  Skips without a card; on
one, run ``python -m pytest -q -m cuda tests/test_torch_cuda.py``."""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
import repro_torch.core as tc
import repro_torch.ops as tops  # (attaches CoProcessor.groupby)
from repro_torch.core import hash_table as ht
from repro_torch.core import interop
from repro_torch.core.phj import partitioned_join
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.agg import agg
from repro_torch.kernels.csr_probe import csr_probe as kcsr
from repro_torch.kernels.csr_probe import ref as csr_ref
from repro_torch.kernels.hash import hash as hsh
from repro_torch.kernels.partition_hist import (fused, partition_hist,
                                                reorder)
from repro_torch.kernels.probe import ops as pops
from repro_torch.kernels.probe import probe as pprobe
from repro_torch.kernels.partition_hist.ref import clustered_pids
from repro_torch.kernels.probe.ref import random_layout
from repro_torch.kernels.sha1_tree import sha1_tree as ksha
from repro_torch.kernels.flash_attn import flash_attn as fa
from repro_torch.kernels.ssd import ssd as kssd
from repro_torch.layers import moe as tmoe
from repro_torch.models import params as tparams

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's Hopper kernels)")
    return torch.device("cuda:0")


@pytest.mark.parametrize("n", [1, 31, 33, 4097, 100_003])
@pytest.mark.parametrize("shift,bits", [(0, 1), (7, 6), (3, 13), (9, 14),
                                        (16, 16)])
def test_kernels_match_plain_versions(dev, n, shift, bits):
    rng = np.random.default_rng(n + bits)
    keys = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, n)
                            .astype(np.int32)).to(dev)
    rid = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
    pid, hist = fused.partition_hist_fused(keys, shift=shift, bits=bits)
    ppid, phist = fused.partition_hist_fused_plain(keys, shift=shift,
                                                   bits=bits)
    assert torch.equal(pid, ppid) and torch.equal(hist, phist)
    starts = torch.cumsum(hist, 0, dtype=torch.int32) - hist
    got = reorder.radix_scatter(rid, keys, pid, starts, num_parts=1 << bits)
    want = reorder.radix_scatter_plain(rid, keys, ppid)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_wrappers_reject_bad_inputs(dev):
    keys64 = torch.zeros(64, dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        fused.partition_hist_fused(keys64, shift=0, bits=4)
    strided = torch.zeros(128, dtype=torch.int32, device=dev)[::2]
    with pytest.raises(ValueError):
        fused.partition_hist_fused(strided, shift=0, bits=4)
    k = torch.zeros(64, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        reorder.radix_scatter(k, k, k, k[:8], num_parts=16)


@pytest.mark.parametrize("kind", ["uniform", "high_skew"])
def test_phj_join_on_card_equals_cpu(dev, kind):
    n = 1 << 15
    gen = (tc.uniform_relation if kind == "uniform" else
           lambda m, seed, device: tc.skewed_relation(
               m, s_percent=25, seed=seed, device=device))
    b, p = gen(n, seed=1, device="cpu"), gen(n, seed=2, device="cpu")
    mo = 2 * n + len(tc.join_oracle(b, p))
    want = tc.phj_join(b, p, max_out=mo)
    reset_launch_counts()
    got = tc.phj_join(b.to(dev), p.to(dev), max_out=mo)
    passes = len(tc.resolve_schedule(n))
    # D: the final headers' pids and the join's bucket ids, per relation;
    # E: the final headers' histogram, per relation; the CSR probe's
    # lookup once and its expand's two grids.
    assert launch_counts() == {"partition_hist_fused": 2 * passes,
                               "radix_scatter": 2 * passes, "seg_agg": 0,
                               "hash_bucket": 4, "radix_hist": 2,
                               "partitioned_probe": 0, "flash_attn": 0,
                               "ssd_intra_chunk": 0, "csr_probe": 3,
                               "sha1_tree": 0}
    for w, g in zip(interop.to_numpy(want), interop.to_numpy(got)):
        assert np.array_equal(w, g)


def _same_result(got, want) -> None:
    for f in ("probe_rid", "build_rid", "count"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("name", csr_ref.CASES)
def test_csr_probe_kernels_match_plain_steps(dev, name):
    brid, bk, bkt, nb, prid, pk, pbkt, mo = csr_ref.csr_case(name)
    brid, bk, bkt, prid, pk, pbkt = (torch.from_numpy(a).to(dev) for a in
                                     (brid, bk, bkt, prid, pk, pbkt))
    table = ht.table_from_buckets(tc.Relation(brid, bk), bkt, nb)
    entry, nmatch = kcsr.csr_lookup_plain(table, pbkt, pk)
    want = kcsr.csr_expand_plain(table, prid, entry, nmatch, mo)
    reset_launch_counts()
    got_entry, got_nmatch = kcsr.csr_lookup(table, pbkt, pk)
    got = kcsr.csr_probe_join(table, pbkt, pk, prid, mo)
    torch.cuda.synchronize()
    assert launch_counts()["csr_probe"] == 4
    assert torch.equal(got_entry, entry) and torch.equal(got_nmatch, nmatch)
    _same_result(got, want)


@pytest.mark.parametrize("kind", ["uniform", "zipf"])
def test_csr_probe_at_2_24_matches_plain_steps(dev, kind):
    """The cells' shapes: 2^24 x 2^24 after one 13-bit pass, 9 bucket
    bits, ``max_out`` 4 n + 1088 and half the pairs; uniform, and a
    Zipf-skewed S whose keys at three ranks match 4096 build tuples
    each.  ``partitioned_join`` launches the lookup and the expand once
    each (the expand in two launches; and D for S's bucket ids), and
    equals the plain steps."""
    n, bits, shj = 1 << 24, 13, 9
    r, s, table, pbkt = csr_ref.phj_probe_inputs(n, kind, (bits,),
                                                 device=dev)
    assert table.num_buckets == 1 << (bits + shj)
    entry, nmatch = kcsr.csr_lookup_plain(table, pbkt, s.key)
    got_entry, got_nmatch = kcsr.csr_lookup(table, pbkt, s.key)
    assert torch.equal(got_entry, entry) and torch.equal(got_nmatch, nmatch)
    if kind == "zipf":
        assert int(nmatch.max()) >= 4096
    mo = 4 * n + 1088
    total = int(nmatch.sum(dtype=torch.int64))
    for max_out in (mo, total // 2):
        want = kcsr.csr_expand_plain(table, s.rid, entry, nmatch, max_out)
        _same_result(kcsr.csr_expand(table, s.rid, entry, nmatch, max_out),
                     want)
    del got_entry, got_nmatch
    reset_launch_counts()
    got = partitioned_join(r, s, total_bits=bits, shj_bits=shj, max_out=mo)
    counts = launch_counts()
    assert counts["csr_probe"] == 3 and counts["hash_bucket"] == 2, counts
    _same_result(got, kcsr.csr_expand_plain(table, s.rid, entry, nmatch, mo))
    assert int(got.count) == total < mo


@pytest.mark.parametrize("name", csr_ref.CASES)
def test_table_probes_on_card_match_plain_steps(dev, name):
    """``probe_hash_table`` and the four variant probes on the card (the
    CSR kernels: lookup and expand, the lookup alone for semi, anti and
    left-outer) equal the same on the CPU (the plain steps)."""
    brid, bk, _, nb, prid, pk, _, mo = csr_ref.csr_case(name)
    t = torch.from_numpy
    table = ht.build_hash_table(tc.Relation(t(brid), t(bk)), nb)
    rel = tc.Relation(t(prid), t(pk))
    gtable, grel = table.to(dev), rel.to(dev)
    reset_launch_counts()
    got = [ht.probe_hash_table(grel, gtable, mo)] + [
        tops.join_variants.probe_hash_table_variant(grel, gtable, mo, kind)
        for kind in tops.join_variants.JOIN_KINDS]
    torch.cuda.synchronize()
    assert launch_counts()["csr_probe"] == 3 + 3 + 3
    want = [ht.probe_hash_table(rel, table, mo)] + [
        tops.join_variants.probe_hash_table_variant(rel, table, mo, kind)
        for kind in tops.join_variants.JOIN_KINDS]
    for g, w in zip(got, want):
        _same_result(g.to("cpu"), w)


def test_phj_query_launches_match_the_roofline_model(dev):
    """One PHJ query through ``CoProcessor.phj`` on the card, cold and with
    both layouts given: its launch counters equal the launch model that
    ``kernels.phj_roofline`` reads (``bench/roofline.py``), and the join
    phase's probe adds the lookup and the expand, which the model leaves
    out."""
    from collections import Counter

    from bench import roofline as rl

    n, sched = 1 << 20, (7, 6)
    b = tc.uniform_relation(n, seed=1, device=dev)
    p = tc.uniform_relation(n, seed=2, device=dev)
    cp = tc.CoProcessor("cpu", dev)
    kw = dict(schedule=sched, shj_bits=2, max_out=4 * n + 1088,
              partition_ratio=0.0, join_ratio=0.0)
    parts = {}
    for hit in (False, True):
        given = (dict(build_parts=parts["R"], probe_parts=parts["S"])
                 if hit else dict(parts_out=parts))
        reset_launch_counts()
        cp.phj(b, p, **kw, **given)
        counts = launch_counts()
        model = Counter(k for k, _ in rl.phj_query_launches(
            n, n, sched, partition_ratio=0.0, join_ratio=0.0,
            build_layout_hit=hit, probe_layout_hit=hit))
        assert +model == +Counter({k: counts[c]
                                   for k, c in rl.COUNTER_OF.items()}), \
            (hit, dict(model), counts)
        assert counts["csr_probe"] == 3, counts


def _heavy_list_join():
    """One key with 2^20 build tuples among 2^16 keys with 1-16 each
    (shuffled), probed by every short key once, the hot key three times
    and 100 keys that match nothing (shuffled)."""
    g = torch.Generator().manual_seed(11)
    hot = 1 << 20
    short = torch.randint(1, 17, (1 << 16,), generator=g)
    bk = torch.cat([torch.full((1 << 20,), hot),
                    torch.repeat_interleave(torch.arange(1 << 16), short)])
    bk = bk[torch.randperm(bk.shape[0], generator=g)].to(torch.int32)
    pk = torch.cat([torch.arange(1 << 16), torch.full((3,), hot),
                    torch.arange(1 << 21, (1 << 21) + 100)])
    pk = pk[torch.randperm(pk.shape[0], generator=g)].to(torch.int32)
    return (tc.Relation(torch.arange(bk.shape[0], dtype=torch.int32), bk),
            tc.Relation(torch.arange(pk.shape[0], dtype=torch.int32), pk))


def _list_join(sizes, order, seed):
    """Build key k holds ``sizes[k]`` tuples (shuffled); the probe keys
    are ``order`` as given, so probe i is lane i % 32 of warp i // 32 in
    the expand's first round."""
    g = torch.Generator().manual_seed(seed)
    bk = torch.repeat_interleave(torch.arange(len(sizes)),
                                 torch.tensor(sizes))
    bk = bk[torch.randperm(bk.shape[0], generator=g)].to(torch.int32)
    pk = torch.tensor(order, dtype=torch.int32)
    return (tc.Relation(torch.arange(bk.shape[0], dtype=torch.int32), bk),
            tc.Relation(torch.arange(pk.shape[0], dtype=torch.int32) + 7,
                        pk))


def _expand_case(name):
    """``(build, probe)`` of a case of the expand's three paths: lists of
    at most ``HEAVY`` rids, up to ``SPLIT``, and longer ones, which the
    second grid writes."""
    sp = kcsr.SPLIT
    if name.startswith("list_2_20"):
        return _heavy_list_join()
    light = list(range(1, 40)) * 8            # keys 0-311: 1-39 rids
    n = len(light)
    if name == "split_edges":                 # SPLIT - 1, SPLIT, SPLIT + 1
        sizes = light + [sp - 1, sp, sp + 1]
        order = list(range(n)) + [n, n + 1, n + 2, n + 2, n + 1]
    elif name == "splits_in_one_warp":        # lanes 0, 3, 4, 17, 31
        sizes = light + [sp + 1, 3 * sp + 5, sp + 77, 5 * sp + 3, 9000]
        hot = {0: 0, 3: 1, 4: 2, 17: 3, 31: 4, 40: 1, 41: 4}
        order = [n + hot[i] if i in hot else i % n for i in range(2 * n)]
    else:                                     # two hot keys mid-probe
        sizes = light + ([3 * sp + 5, 2 * sp + 9] if name != "no_split"
                         else [sp, sp // 2 + 3])
        order = (list(range(0, n, 2)) + [n, n + 1] + list(range(1, n, 2))
                 + [n + 1, n])
    return _list_join(sizes, order, seed=len(name))


def _expand_max_out(name, m: torch.Tensor) -> int:
    """Half the pairs for "list_2_20_truncated"; for
    "split_straddles_max_out" the middle of the first split list, so the
    next starts past ``max_out``; else all the pairs and 64 slots."""
    if name == "list_2_20_truncated":
        return int(m.sum()) // 2
    if name == "split_straddles_max_out":
        first = int(torch.nonzero(m > kcsr.SPLIT)[0])
        return int(m[:first].sum()) + int(m[first]) // 2 + 1
    return int(m.sum()) + 64


EXPAND_CASES = ("list_2_20", "list_2_20_truncated", "split_edges",
                "splits_in_one_warp", "split_straddles_max_out", "no_split")


@pytest.mark.parametrize("case", EXPAND_CASES)
def test_csr_expand_counts_a_2_20_rid_list_exactly(dev, case):
    """The expand on tables with rid lists up to ``HEAVY`` (thread-
    written), up to ``SPLIT`` (warp-written) and longer (queued and split
    across the second grid): one of 2^20 rids among many short ones, cut
    short or not; lists of ``SPLIT`` - 1, ``SPLIT`` and ``SPLIT`` + 1 rids;
    five split lists among the 32 probes of one warp; a split list that
    ``max_out`` cuts and one that starts past it; none longer than
    ``SPLIT`` (the second launch finds the queue empty).  Its pairs equal
    the plain expand's bit for bit and its counters
    ``count_expand_plain``'s, exactly."""
    b, p = _expand_case(case)
    table = ht.build_hash_table(b, 1 << 14)
    bkt = ht.probe_p1(p.key, table.num_buckets)
    entry, nmatch = kcsr.csr_lookup_plain(table, bkt, p.key)
    m = nmatch.to(torch.int64)
    mo = _expand_max_out(case, m)
    want = torch.zeros(len(kcsr.EXPAND_COUNTERS), dtype=torch.int64)
    kcsr.count_expand_plain(nmatch, want)
    split = m > kcsr.SPLIT
    assert want.tolist() == [int(m.sum()), int(m[m > kcsr.HEAVY].sum()),
                             int(m.max()), int(m[split].sum())]
    st = torch.cumsum(m, 0) - m
    holds = {
        "list_2_20": int(m.max()) == 1 << 20 and int(split.sum()) == 3,
        "list_2_20_truncated": int(m.max()) == 1 << 20 and mo < int(m.sum()),
        "split_edges": sorted(set(m[m > 39].tolist())) == [
            kcsr.SPLIT - 1, kcsr.SPLIT, kcsr.SPLIT + 1],
        "splits_in_one_warp": int(split[:32].sum()) == 5,
        "split_straddles_max_out": bool(
            (split & (st < mo) & (st + m > mo)).any())
        and bool((split & (st >= mo)).any()),
        "no_split": not split.any() and int(m.max()) == kcsr.SPLIT,
    }[case]
    assert holds
    gtable, grid, gentry, gnmatch = (x.to(dev) for x in
                                     (table, p.rid, entry, nmatch))
    counters = torch.zeros_like(want, device=dev)
    reset_launch_counts()
    got = kcsr.csr_expand(gtable, grid, gentry, gnmatch, mo,
                          counters=counters)
    assert launch_counts()["csr_probe"] == 2
    _same_result(got, kcsr.csr_expand_plain(gtable, grid, gentry, gnmatch,
                                            mo))
    assert counters.tolist() == want.tolist()


def test_traced_partitioned_join_counts_its_expand_on_the_card(dev):
    """``partitioned_join`` traced on the card: ``join.expand`` is timed
    inside ``join.probe`` and carries the counts the CPU's traced join
    gives, once the device has passed it; the answer is the CPU's."""
    from repro_torch.obs.trace import Tracer

    b, p = _heavy_list_join()
    kw = dict(total_bits=7, shj_bits=6, max_out=4 << 20)
    cpu, card = Tracer(), Tracer()
    want = partitioned_join(b, p, tracer=cpu, **kw)
    got = partitioned_join(b.to(dev), p.to(dev), tracer=card, **kw)
    torch.cuda.synchronize()
    _same_result(got.to("cpu"), want)
    spans = {s.name: s for s in card.spans()}
    expand, probe = spans["join.expand"], spans["join.probe"]
    assert 0 < expand.device_s <= probe.device_s
    (cpu_expand,) = [s for s in cpu.spans() if s.name == "join.expand"]
    names = kcsr.EXPAND_COUNTERS
    assert [expand.attrs[k] for k in names] == \
        [cpu_expand.attrs[k] for k in names]
    assert expand.attrs["warp_max_pairs"] == 1 << 20
    assert expand.attrs["split_pairs"] == 3 << 20


def test_csr_probe_wrappers_reject_bad_inputs(dev):
    brid, bk, bkt, nb, prid, pk, pbkt, mo = csr_ref.csr_case("truncated")
    table = ht.table_from_buckets(
        tc.Relation(torch.from_numpy(brid), torch.from_numpy(bk)),
        torch.from_numpy(bkt), nb).to(dev)
    key = torch.from_numpy(pk).to(dev)
    with pytest.raises(TypeError):
        kcsr.csr_lookup(table, torch.from_numpy(pbkt).to(dev).long(), key)
    with pytest.raises(ValueError):
        kcsr.csr_lookup(table, torch.from_numpy(pbkt), key)
    with pytest.raises(ValueError):
        kcsr.csr_expand(table, key, key, key[:-1], mo)
    with pytest.raises(ValueError):
        kcsr.csr_expand(table, key, key, key, 2**31)


def test_coprocessor_dd_on_card_equals_cpu(dev):
    n = 1 << 14
    b = tc.uniform_relation(n, seed=1, device="cpu")
    p = tc.uniform_relation(n, seed=2, device="cpu")
    kw = dict(shj_bits=2, max_out=3 * n, partition_ratio=0.25,
              join_ratio=0.4)
    want, _ = tc.CoProcessor("cpu", "cpu").phj(b, p, **kw)
    got, t = tc.CoProcessor("cpu", dev).phj(b.to(dev), p.to(dev), **kw)
    for w, g in zip(interop.to_numpy(want), interop.to_numpy(got)):
        assert np.array_equal(w, g)
    assert t.phase_s["partition"] > 0 and t.phase_s["join"] > 0


def _ints(rng, n, lo=-2**31, hi=2**31):
    return rng.integers(lo, hi, n, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("n", [1, 33, 4097, 100_003])
@pytest.mark.parametrize("slots", [1, 1000, None])
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
@pytest.mark.parametrize("wrap32", [False, True])
def test_seg_agg_matches_plain_version(dev, n, slots, order, wrap32):
    rng = np.random.default_rng(n)
    s = slots or n                                  # None: S = n
    gid = rng.integers(-1, s + 2, n).astype(np.int32)
    if order == "sorted":
        gid.sort()
    g = torch.from_numpy(gid).to(dev)
    v = torch.from_numpy(_ints(rng, n)).to(dev)
    got = agg.seg_agg(g, v, num_slots=s, wrap32=wrap32)
    want = agg.seg_agg_plain(g, v, num_slots=s, wrap32=wrap32)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("n", [1, 33, 4097, 100_003])
def test_hash_and_hist_match_plain_versions(dev, n):
    rng = np.random.default_rng(n)
    keys = torch.from_numpy(_ints(rng, n)).to(dev)
    for b in (1, 2, 1 << 7, 1 << 13, 1 << 31):
        assert torch.equal(hsh.hash_bucket(keys, num_buckets=b),
                           hsh.hash_bucket_plain(keys, num_buckets=b))
    for p in (1, 2, 1 << 7, 1 << 13, 1 << 16):
        pid = torch.from_numpy(rng.integers(-2, p + 2, n)
                               .astype(np.int32)).to(dev)
        assert torch.equal(partition_hist.radix_hist(pid, num_parts=p),
                           partition_hist.radix_hist_plain(pid, num_parts=p))


def test_new_wrappers_reject_bad_inputs(dev):
    k64 = torch.zeros(64, dtype=torch.int64, device=dev)
    strided = torch.zeros(128, dtype=torch.int32, device=dev)[::2]
    with pytest.raises(TypeError):
        hsh.hash_bucket(k64, num_buckets=4)
    with pytest.raises(ValueError):
        partition_hist.radix_hist(strided, num_parts=4)
    with pytest.raises(TypeError):
        agg.seg_agg(k64, k64, num_slots=4)
    with pytest.raises(ValueError):
        agg.seg_agg(strided, strided[:32], num_slots=4)


@pytest.mark.parametrize("schedule,pr,ar", [
    (None, 0.0, 0.0), (None, 0.5, 0.5), ((7, 6), 0.0, 0.0),
    ((7, 6), 0.25, 0.4), ((3, 2), 1.0, 0.25)])
@pytest.mark.parametrize("wrap32", [False, True])
def test_groupby_on_card_equals_cpu(dev, schedule, pr, ar, wrap32):
    n = 1 << 16
    rng = np.random.default_rng(8)
    keys = rng.integers(0, n // 64, n).astype(np.int32)
    vals = _ints(rng, n)
    rel = tc.Relation(torch.arange(n, dtype=torch.int32),
                      torch.from_numpy(keys))
    kw = dict(schedule=schedule, partition_ratio=pr, agg_ratio=ar,
              wrap32=wrap32)
    want, _ = tc.CoProcessor("cpu", "cpu").groupby(rel, vals, **kw)
    reset_launch_counts()
    got, t = tc.CoProcessor("cpu", dev).groupby(
        rel.to(dev), torch.from_numpy(vals).to(dev), **kw)
    counts = launch_counts()
    for f in ("keys", "counts", "sums", "mins", "maxs"):
        w, g = getattr(want, f), getattr(got, f)
        assert w.dtype == g.dtype and np.array_equal(w, g), f
    if ar < 1.0:
        assert counts["seg_agg"] > 0
    if schedule and pr < 1.0:     # A, B, then D and E on the headers
        assert all(counts[k] > 0 for k in ("partition_hist_fused",
                                           "radix_scatter", "hash_bucket",
                                           "radix_hist"))
    assert t.phase_s["agg"] > 0


@pytest.mark.parametrize("p,k,m", [(1, 8, 8), (16, 8, 300), (8192, 8, 128),
                                   (1, 2304, 5000), (16, 2304, 2304),
                                   (8192, 2304, 2304), (16, 32768, 4096),
                                   (1, 1 << 20, 1 << 16)])
def test_partitioned_probe_matches_plain_version(dev, p, k, m):
    tk, tr, pk = random_layout(p, k, m, seed=p + k, device=dev)
    got = pprobe.probe(tk, tr, pk)
    assert torch.equal(got, pprobe.probe_plain(tk, tr, pk))
    if k == 1 << 20:          # longer than shared memory holds
        assert k > pprobe.max_shared_keys()


@pytest.mark.parametrize("n", [1, 3, (1 << 20) + 3])
@pytest.mark.parametrize("p", [1, 2, 1 << 13, 1 << 14, 1 << 17])
@pytest.mark.parametrize("aligned", [True, False])
def test_radix_hist_clustered_matches_plain_version(dev, n, p, aligned):
    """Kernel E on clustered pids (sorted runs crossing vector, warp and
    block edges, with -1, P and P + 1 inside them), ragged n, on a vector
    4 bytes past a 16-byte boundary too (its scalar head)."""
    base = clustered_pids(n + 1, p, seed=n + p, device=dev)
    pid = base[:n] if aligned else base[1:]
    assert torch.equal(partition_hist.radix_hist(pid, num_parts=p),
                       partition_hist.radix_hist_plain(pid, num_parts=p))


@pytest.mark.parametrize("p,k,m", [(16, 1, 300), (64, 36, 129),
                                   (64, 37, 129), (16, 2304, 2304),
                                   (8192, 2304, 2432), (16, 32768, 4096),
                                   (1, 1 << 20, 1 << 16)])
def test_partitioned_probe_unsorted_rows_match_plain_version(dev, p, k, m):
    """Kernel F agrees with the reference's search on rows that are not
    sorted (each row's pairs permuted), through the TMA ring (K = 36,
    2304), the one-block-per-row kernel (K = 1, 37, 32768) and device
    memory (2^20)."""
    tk, tr, pk = random_layout(p, k, m, seed=p + k, device=dev,
                               sorted_rows=False)
    assert torch.equal(pprobe.probe(tk, tr, pk),
                       pprobe.probe_plain(tk, tr, pk))


def test_partitioned_probe_unaligned_rows_match_plain_version(dev):
    """Tensors that start 4 bytes past a 16-byte boundary."""
    def offset(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)
    tk, tr, pk = (offset(t) for t in random_layout(64, 36, 100, seed=5,
                                                   device=dev))
    assert torch.equal(pprobe.probe(tk, tr, pk),
                       pprobe.probe_plain(tk, tr, pk))


@pytest.mark.parametrize("bits", [4, 7])
def test_partitioned_probe_negative_layout_matches_plain_version(dev, bits):
    """build_partitioned_table's rows when the build side holds negative
    keys (tests/test_torch_probe.py's "negative" kind): [non-negative
    ascending][negative ascending][INT_MAX pads], not sorted as uint32
    across the pads; card against plain version and against the CPU."""
    nb, np_ = 1 << 12, 1 << 13
    rng = np.random.default_rng(nb + bits)
    b = tc.Relation(torch.arange(nb, dtype=torch.int32),
                    torch.from_numpy(rng.integers(-nb, nb, nb)
                                     .astype(np.int32)))
    p = tc.Relation(torch.arange(np_, dtype=torch.int32),
                    torch.from_numpy(rng.integers(-nb // 2, 3 * nb // 2, np_)
                                     .astype(np.int32)))
    layout = pops.build_partitioned_table(b.to(dev), p.to(dev),
                                          total_bits=bits)
    got = pops.probe(*layout[:3])
    assert torch.equal(got, pprobe.probe_plain(*layout[:3]))
    want = pops.probe(*pops.build_partitioned_table(b, p,
                                                    total_bits=bits)[:3])
    assert torch.equal(got.cpu(), want)


def test_probe_wrapper_rejects_bad_inputs(dev):
    t = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        pprobe.probe(t.to(torch.int64), t, t)
    with pytest.raises(ValueError):
        pprobe.probe(t.t().contiguous().t(), t, t)
    with pytest.raises(ValueError):
        pprobe.probe(t, t, t.cpu())


@pytest.mark.parametrize("n,bits", [(1 << 12, 4), (1 << 16, 7)])
def test_partitioned_probe_join_on_card_equals_cpu(dev, n, bits):
    b = tc.unique_relation(n, seed=1, device="cpu")
    p = tc.uniform_relation(2 * n, key_range=3 * n // 2, seed=2,
                            device="cpu")
    want = pops.build_partitioned_table(b, p, total_bits=bits)
    reset_launch_counts()
    got = pops.build_partitioned_table(b.to(dev), p.to(dev),
                                       total_bits=bits)
    rid = pops.probe(*got[:3])
    counts = launch_counts()
    assert counts["hash_bucket"] == 2 and counts["radix_hist"] == 2
    assert counts["partitioned_probe"] == 1
    for w, g in zip(want, got):
        assert torch.equal(w, g.cpu())
    assert torch.equal(pops.probe(*want[:3]), rid.cpu())


SHJ_SCHEMES = {
    "cpu_only": ([1.0] * 4, [1.0] * 4), "gpu_only": ([0.0] * 4, [0.0] * 4),
    "ol": ([1.0] * 4, [0.0] * 4), "dd": ([0.25] * 4, [0.42] * 4),
    "pl": ([0.0, 0.25, 0.5, 0.25], [0.0, 0.25, 0.75, 0.25])}


def _shj_data(n=1 << 14):
    b = tc.uniform_relation(n, seed=1, device="cpu")
    p = tc.uniform_relation(n, seed=2, device="cpu")
    return b, p, 2 * n + len(tc.join_oracle(b, p))


@pytest.mark.parametrize("mode", ["shared", "separate"])
@pytest.mark.parametrize("scheme", list(SHJ_SCHEMES))
def test_shj_on_card_equals_cpu(dev, scheme, mode):
    b, p, mo = _shj_data()
    br, pr = SHJ_SCHEMES[scheme]
    kw = dict(num_buckets=1 << 12, max_out=mo, build_ratios=br,
              probe_ratios=pr, table_mode=mode)
    want, wt = tc.CoProcessor("cpu", "cpu").shj(b, p, **kw)
    reset_launch_counts()
    got, t = tc.CoProcessor("cpu", dev).shj(b.to(dev), p.to(dev), **kw)
    for w, g in zip(interop.to_numpy(want), interop.to_numpy(got)):
        assert np.array_equal(w, g)
    assert t.transfer_bytes == wt.transfer_bytes
    if scheme != "cpu_only":
        assert launch_counts()["hash_bucket"] > 0


def test_shj_discrete_and_basic_unit_on_card_equal_cpu(dev):
    b, p, mo = _shj_data()
    kw = dict(num_buckets=1 << 12, max_out=mo, build_ratios=[0.25] * 4,
              probe_ratios=[0.42] * 4, table_mode="separate")
    link = dict(link=tc.PCIE_LINK, discrete=True)
    want, wt = tc.CoProcessor("cpu", "cpu", **link).shj(b, p, **kw)
    got, t = tc.CoProcessor("cpu", dev, **link).shj(b.to(dev), p.to(dev),
                                                    **kw)
    for w, g in zip(interop.to_numpy(want), interop.to_numpy(got)):
        assert np.array_equal(w, g)
    assert t.transfer_bytes == wt.transfer_bytes > 0
    kw = dict(num_buckets=1 << 12, max_out=mo, chunk=1 << 12)
    want, _, _ = tc.CoProcessor("cpu", "cpu").basic_unit_shj(b, p, **kw)
    got, _, ratios = tc.CoProcessor("cpu", dev).basic_unit_shj(
        b.to(dev), p.to(dev), **kw)
    for w, g in zip(interop.to_numpy(want), interop.to_numpy(got)):
        assert np.array_equal(w, g)
    assert all(0.0 <= r <= 1.0 for r in ratios.values())


@pytest.mark.parametrize("kind", ["semi", "anti", "left_outer"])
@pytest.mark.parametrize("ratio", [0.0, 0.5, 1.0])
def test_join_variants_on_card_equal_cpu(dev, kind, ratio):
    b, p, mo = _shj_data()
    cpu, card = tc.CoProcessor("cpu", "cpu"), tc.CoProcessor("cpu", dev)
    kw = dict(num_buckets=1 << 12, ratios=[0.0] * 4)
    want_t, _ = cpu.build_table(b, **kw)
    got_t, _ = card.build_table(b.to(dev), **kw)
    for w, g in zip(interop.to_numpy(want_t), interop.to_numpy(got_t)):
        assert np.array_equal(w, g)
    kw = dict(kind=kind, max_out=mo, ratios=[ratio] * 4)
    want, _ = tops.probe_table_variant(cpu, p, want_t, **kw)
    got, _ = tops.probe_table_variant(card, p.to(dev), got_t, **kw)
    for w, g in zip(interop.to_numpy(want), interop.to_numpy(got)):
        assert np.array_equal(w, g)
    assert np.array_equal(got.valid_pairs(),
                          tops.join_variant_oracle(b, p, kind))


def _close(got, want, tol):
    """tests/test_kernels.py's assert_allclose(rtol=tol, atol=tol)."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    bad = (got - want).abs() > tol + tol * want.abs()
    assert not bad.any(), float((got - want).abs().max())


GRID_G = [(2, 256, 256, 4, 2, 64, True), (1, 128, 384, 8, 8, 128, False),
          (2, 256, 256, 4, 4, 32, True), (1, 256, 256, 8, 2, 64, True),
          (1, 1000, 1000, 4, 2, 96, True), (2, 37, 37, 4, 4, 16, True),
          (1, 100, 260, 8, 2, 128, False), (1, 1, 1, 2, 1, 64, True),
          (1, 256, 256, 24, 8, 64, True), (1, 256, 256, 40, 8, 128, True),
          # whisper_large_v3: the encoder over 1500 frames, cross attention
          # of 224, 4 and 1 queries over them, the decoder's own prefill.
          (2, 1500, 1500, 20, 20, 64, False), (2, 224, 1500, 20, 20, 64, False),
          (8, 4, 1500, 20, 20, 64, False), (1, 1, 1500, 20, 20, 64, False),
          (8, 4, 4, 20, 20, 64, True), (1, 1500, 1500, 20, 20, 64, False),
          # zamba2_1_2b's training microbatch: key tiles past 2048.
          (2, 4096, 4096, 32, 32, 64, True)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", GRID_G)
def test_flash_attn_matches_plain_version(dev, b, sq, sk, h, kv, d, causal,
                                          dtype, tol):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(sq + d)
    q = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, sk, kv, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, sk, kv, d, generator=g, device=dev).to(dtype)
    n = launch_counts()["flash_attn"]
    got = fa.flash_attention(q, k, v, num_kv_heads=kv, causal=causal)
    assert launch_counts()["flash_attn"] == n + 1 and got.dtype == dtype
    _close(got, fa.flash_attention_plain(q, k, v, num_kv_heads=kv,
                                         causal=causal), tol)


GRID_H = [(2, 3, 64, 4, 32, 16), (1, 2, 128, 8, 64, 64),
          (1, 2, 128, 4, 64, 128), (1, 1, 37, 4, 16, 16),
          (2, 2, 256, 8, 64, 128), (1, 3, 200, 3, 32, 64)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("bs,nc,q,h,p,n", GRID_H)
def test_ssd_intra_chunk_matches_plain_version(dev, bs, nc, q, h, p, n,
                                               dtype, tol):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(q + n)
    x = torch.randn(bs, nc, q, h, p, generator=g, device=dev).to(dtype)
    dt = torch.rand(bs, nc, q, h, generator=g, device=dev) * 0.19 + 0.01
    b = torch.randn(bs, nc, q, n, generator=g, device=dev).to(dtype)
    c = torch.randn(bs, nc, q, n, generator=g, device=dev).to(dtype)
    a = -torch.exp(torch.randn(h, generator=g, device=dev) * 0.3)
    n0 = launch_counts()["ssd_intra_chunk"]
    got = kssd.ssd_intra_chunk(x, dt, b, c, a)
    assert launch_counts()["ssd_intra_chunk"] == n0 + 1 and got.dtype == torch.float32
    _close(got, kssd.ssd_intra_chunk_plain(x, dt, b, c, a), tol)


# chip_smoke.py's GRID_H (Zamba2's prefill, Mamba2-2.7B's N = 128 and a
# ragged chunk of 37) and a one-row chunk.
GRID_H_VARIANTS = [(2, 3, 64, 4, 32, 16), (1, 2, 128, 8, 64, 64),
                   (1, 2, 128, 4, 64, 128), (4, 8, 256, 64, 64, 64),
                   (1, 4, 256, 80, 64, 128), (2, 1, 37, 64, 64, 64),
                   (1, 1, 1, 2, 16, 64)]


@pytest.mark.parametrize("variant", ["wgmma", "cuda_cores"])
@pytest.mark.parametrize("bs,nc,q,h,p,n", GRID_H_VARIANTS)
def test_ssd_intra_chunk_variants_match_plain_version(dev, bs, nc, q, h, p,
                                                      n, variant):
    """Both variants of kernel H on bfloat16 inputs (wgmma is the one
    that serves them), within tests/test_kernels.py's 3e-2."""
    g = torch.Generator(device=dev).manual_seed(q + n + h)
    x = torch.randn(bs, nc, q, h, p, generator=g, device=dev).bfloat16()
    dt = torch.rand(bs, nc, q, h, generator=g, device=dev) * 0.19 + 0.01
    b = torch.randn(bs, nc, q, n, generator=g, device=dev).bfloat16()
    c = torch.randn(bs, nc, q, n, generator=g, device=dev).bfloat16()
    a = -torch.exp(torch.randn(h, generator=g, device=dev) * 0.3)
    before = dict(kssd.launches_by_variant)
    got = kssd.ssd_intra_chunk(x, dt, b, c, a, variant=variant)
    assert kssd.launches_by_variant[variant] == before[variant] + 1
    _close(got, kssd.ssd_intra_chunk_plain(x, dt, b, c, a), 3e-2)


def test_ssd_intra_chunk_variants_by_dtype(dev):
    reset_launch_counts()
    x = torch.randn(1, 2, 64, 2, 64, device=dev)
    dt = torch.rand(1, 2, 64, 2, device=dev)
    bc = torch.randn(1, 2, 64, 16, device=dev)
    a = -torch.rand(2, device=dev)
    kssd.ssd_intra_chunk(x, dt, bc, bc, a)
    kssd.ssd_intra_chunk(x.bfloat16(), dt, bc.bfloat16(), bc.bfloat16(), a)
    assert kssd.launches_by_variant == {"cuda_cores": 1, "wgmma": 1}
    with pytest.raises(TypeError):                # wgmma takes bfloat16
        kssd.ssd_intra_chunk(x, dt, bc, bc, a, variant="wgmma")
    with pytest.raises(ValueError):               # TMA's 16-byte base
        xs = torch.zeros(2 * 64 * 2 * 64 + 1, device=dev,
                         dtype=torch.bfloat16)[1:].view(1, 2, 64, 2, 64)
        kssd.ssd_intra_chunk(xs, dt, bc.bfloat16(), bc.bfloat16(), a)


@pytest.mark.parametrize("n", [0, 1, 5, (1 << 20) + 3])
@pytest.mark.parametrize("bits", [1, 2, 7, 13, 17, 18])
@pytest.mark.parametrize("aligned", [True, False])
def test_partition_hist_fused_digits_match_plain_version(dev, bits, n,
                                                         aligned):
    """Kernel A at narrow (match aggregation), shared-memory and global
    (17-18 bits) histograms, on vectors that end past the last whole int4
    and on keys 4 bytes past an aligned address (the scalar path)."""
    rng = np.random.default_rng(n + bits)
    base = torch.from_numpy(_ints(rng, n + 1)).to(dev)
    keys = base[:n] if aligned else base[1:]
    shift = 0 if bits > 13 else 7
    got = fused.partition_hist_fused(keys, shift=shift, bits=bits)
    want = fused.partition_hist_fused_plain(keys, shift=shift, bits=bits)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("bits", [17, 18])
def test_wide_partitions_match_plain_versions(dev, bits):
    """Kernels B (device-memory cursors) and E (global histogram) at 2^17
    and 2^18 partitions."""
    p, n = 1 << bits, (1 << 20) + 7
    rng = np.random.default_rng(bits)
    pid = torch.from_numpy(rng.integers(0, p, n).astype(np.int32)).to(dev)
    spill = torch.from_numpy(rng.integers(-3, p + 3, n)
                             .astype(np.int32)).to(dev)
    assert torch.equal(partition_hist.radix_hist(spill, num_parts=p),
                       partition_hist.radix_hist_plain(spill, num_parts=p))
    rid = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
    key = torch.from_numpy(_ints(rng, n)).to(dev)
    hist = partition_hist.radix_hist(pid, num_parts=p)
    starts = torch.cumsum(hist, 0, dtype=torch.int32) - hist
    got = reorder.radix_scatter(rid, key, pid, starts, num_parts=p)
    want = reorder.radix_scatter_plain(rid, key, pid)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("sched", [(17,), (9, 9)])
def test_wide_phj_join_on_card_equals_cpu(dev, sched):
    """phj_join over pass schedules past 16 bits, card against CPU."""
    b = tc.uniform_relation(1 << 14, seed=1, device="cpu")
    s_ = tc.uniform_relation(1 << 14, seed=2, device="cpu")
    want = tc.phj_join(b, s_, schedule=sched, max_out=1 << 16)
    got = tc.phj_join(b.to(dev), s_.to(dev), schedule=sched,
                      max_out=1 << 16)
    assert np.array_equal(got.valid_pairs(), want.valid_pairs())
    assert np.array_equal(want.valid_pairs(), tc.join_oracle(b, s_))


@pytest.mark.parametrize("sq", [1, 127, 128, 129, 1000, 2048])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attn_wgmma_matches_plain_version(dev, d, causal, group, sq):
    """The wgmma variant over ragged and tile-sized lengths.  Sq = 1 and
    129 leave a query tile whose second warpgroup holds only padding rows;
    the full case reads Sk = Sq + 37 keys."""
    sk = sq if causal else sq + 37
    h = 4
    g = torch.Generator(device=dev).manual_seed(sq * 7 + d + group)
    q = torch.randn(1, sq, h, d, generator=g, device=dev).bfloat16()
    k = torch.randn(1, sk, h // group, d, generator=g, device=dev).bfloat16()
    v = torch.randn(1, sk, h // group, d, generator=g, device=dev).bfloat16()
    before = fa.launches_by_variant["wgmma"]
    got = fa.flash_attention(q, k, v, num_kv_heads=h // group,
                             causal=causal)
    assert fa.launches_by_variant["wgmma"] == before + 1
    _close(got, fa.flash_attention_plain(q, k, v, num_kv_heads=h // group,
                                         causal=causal), 2e-2)


def test_flash_attn_variants_by_head_dim(dev):
    reset_launch_counts()
    for d in (64, 128, 32, 96):
        q = torch.randn(1, 130, 2, d, device=dev).bfloat16()
        fa.flash_attention(q, q, q, num_kv_heads=2)
    q = torch.randn(1, 130, 2, 64, device=dev)
    fa.flash_attention(q, q, q, num_kv_heads=2)
    assert fa.launches_by_variant == {"cuda_cores": 1, "mma_sync": 2,
                                      "wgmma": 2}
    assert launch_counts()["flash_attn"] == 5


@pytest.mark.parametrize("order", ["uniform", "one_partition", "descending"])
@pytest.mark.parametrize("bits", [1, 6, 7, 11, 13, 16])
@pytest.mark.parametrize("n_of", ["tile-1", "tile", "tile+1", "3tile+17",
                                  "2^22+5"])
def test_radix_scatter_tiles_match_plain_version(dev, n_of, bits, order):
    """Kernel B at tile edges on both paths (shared memory up to 11 bits,
    device memory above), bit for bit against a stable sort."""
    p = 1 << bits
    tile = reorder.tile_len(p)
    n = {"tile-1": tile - 1, "tile": tile, "tile+1": tile + 1,
         "3tile+17": 3 * tile + 17, "2^22+5": (1 << 22) + 5}[n_of]
    rng = np.random.default_rng(n + bits)
    pid = rng.integers(0, p, n).astype(np.int32)
    if order == "one_partition":
        pid[:] = p // 2
    elif order == "descending":
        pid = -np.sort(-pid)
    pid_t = torch.from_numpy(pid).to(dev)
    rid = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
    key = torch.from_numpy(_ints(rng, n)).to(dev)
    hist = torch.bincount(pid_t, minlength=p).to(torch.int32)
    starts = torch.cumsum(hist, 0, dtype=torch.int32) - hist
    got = reorder.radix_scatter(rid, key, pid_t, starts, num_parts=p)
    want = reorder.radix_scatter_plain(rid, key, pid_t)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_lm_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 8, 4, 48, device=dev)
    with pytest.raises(ValueError):               # head_dim 48
        fa.flash_attention(q, q, q, num_kv_heads=4)
    q = torch.zeros(1, 8, 4, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q, num_kv_heads=4)
    x = torch.zeros(1, 1, 300, 2, 64, device=dev)
    dt = torch.zeros(1, 1, 300, 2, device=dev)
    bc = torch.zeros(1, 1, 300, 16, device=dev)
    a = torch.zeros(2, device=dev)
    with pytest.raises(ValueError):               # chunk above 256
        kssd.ssd_intra_chunk(x, dt, bc, bc, a)
    with pytest.raises(ValueError):               # d_state 32
        kssd.ssd_intra_chunk(x[:, :, :8], dt[:, :, :8],
                             bc[:, :, :8, :8].repeat(1, 1, 1, 4),
                             bc[:, :, :8, :8].repeat(1, 1, 1, 4), a)


@pytest.mark.parametrize("arch", ["zamba2_1_2b", "mamba2_2_7b",
                                  "qwen3_8b"])
def test_lm_generate_on_card_matches_cpu(dev, arch):
    """Reduced configs in float32: the card runs G and H in every prefill
    and forward, the CPU their plain versions."""
    import dataclasses

    import repro_torch.configs as tcfgs
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(tcfgs.reduced(tcfgs.get_config(arch)),
                              dtype="float32")
    cpu = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    card = tfm.init_params(cfg, torch.Generator().manual_seed(0)).to(dev)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 37)).astype(np.int32))
    want, wl = ServeEngine(cfg, cpu, 45).generate(toks, 8,
                                                  return_logits=True)
    reset_launch_counts()
    got, gl = ServeEngine(cfg, card, 45).generate(toks.to(dev), 8,
                                                  return_logits=True)
    counts = launch_counts()
    n_a = (cfg.pattern_unit * cfg.num_units + cfg.tail).count("D") + \
        (cfg.pattern_unit * cfg.num_units + cfg.tail).count("A")
    n_m = (cfg.pattern_unit * cfg.num_units + cfg.tail).count("M")
    assert counts["flash_attn"] == n_a and counts["ssd_intra_chunk"] == n_m
    v = cfg.vocab_size
    rel = ((gl.cpu() - wl)[..., :v].abs().max()
           / wl[..., :v].abs().max()).item()
    assert rel < 1e-4, rel
    assert torch.equal(got.cpu(), want)


def test_encdec_on_card_matches_cpu(dev):
    """Reduced whisper in float32: the card runs G three ways per layer in
    the prefill (encoder, decoder, cross), none in decode; its prefill and
    decode logits match the CPU port's."""
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(
        tconfigs.reduced(tconfigs.get_config("whisper_large_v3")),
        dtype="float32")
    cpu = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    card = tfm.init_params(cfg, torch.Generator().manual_seed(0)).to(dev)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32))
    frames = torch.from_numpy((rng.standard_normal(
        (2, cfg.encoder.num_frames, cfg.d_model)) * 0.02).astype(np.float32))
    want, wl = ServeEngine(cfg, cpu, 15).generate(toks, 6, frames,
                                                  return_logits=True)
    reset_launch_counts()
    got, gl = ServeEngine(cfg, card, 15).generate(
        toks.to(dev), 6, frames.to(dev), return_logits=True)
    assert launch_counts()["flash_attn"] == \
        cfg.encoder.num_layers + 2 * cfg.num_layers
    v = cfg.vocab_size
    rel = ((gl.cpu() - wl)[..., :v].abs().max()
           / wl[..., :v].abs().max()).item()
    assert rel < 1e-4, rel
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("workers", [0, 2])
def test_service_on_card_is_exact_and_synced(dev, workers):
    """``JoinQueryService`` over a C group on the host and a G group on
    the card: results exact against the oracle, each outcome's wall time
    no less than the sum of its synchronized phase times, and a repeated
    build relation served from the cache without a build."""
    import repro_torch.engine as te

    cp = tc.CoProcessor(c_device="cpu", g_device=dev)
    svc = te.JoinQueryService(cp=cp, num_workers=workers)
    qs = te.make_workload("mixed", 12, base_tuples=1 << 14, seed=0,
                          device=dev)
    reset_launch_counts()
    outs = svc.run(qs)
    counts = launch_counts()
    # The first query again, after the stream: its table is resident.
    qs.append(te.JoinQuery(qs[0].build, qs[0].probe, query_id=99))
    outs.append(svc.execute(qs[-1]))
    assert counts["hash_bucket"] > 0
    for q, o in zip(qs, outs):
        exp = tc.join_oracle(q.build, q.probe)
        assert np.array_equal(o.result.valid_pairs(), exp), q.tag
        assert o.wall_s >= sum(o.timing.phase_s.values()) > 0
    hits = [o for o in outs if o.cache_hit]
    assert outs[-1].cache_hit
    assert all(o.timing.phase_s["build"] == 0.0 for o in hits)
    assert svc.stats()["cache"]["hits"] == len(hits)
    svc.close()


def test_service_on_card_runs_phj_groupby_and_faults(dev):
    """PHJ plans with partition-layout reuse, a group-by and a kernel
    fault through the recovery ladder, all on the card and exact."""
    import repro_torch.engine as te

    cp = tc.CoProcessor(c_device="cpu", g_device=dev)
    planner = te.QueryPlanner(cache_bytes=1 << 10, rand_penalty=8.0,
                              phj_overhead_s=0.0)
    svc = te.JoinQueryService(cp=cp, planner=planner, num_workers=0)
    n = 1 << 15
    b = tc.uniform_relation(n, seed=1, device=dev)
    p = tc.uniform_relation(n, seed=2, device=dev)
    exp = tc.join_oracle(b, p)
    reset_launch_counts()
    outs = [svc.execute(te.JoinQuery(b, p, query_id=i)) for i in range(2)]
    assert launch_counts()["partition_hist_fused"] > 0
    assert [o.plan.algorithm for o in outs] == ["phj", "phj"]
    assert [o.partition_cache_hit for o in outs] == [False, True]
    for o in outs:
        assert np.array_equal(o.result.valid_pairs(), exp)
    keys = tc.uniform_relation(n, key_range=n // 64, seed=3, device=dev)
    vals = torch.arange(n, dtype=torch.int32, device=dev)
    out = svc.execute(te.GroupByQuery(keys, vals, query_id=3))
    want = tops.groupby_ref(keys.key.cpu().numpy(), np.arange(n))
    got = out.result.sorted()
    for f in ("keys", "counts", "sums", "mins", "maxs"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    svc = te.JoinQueryService(cp=cp, num_workers=0,
                              retry=te.RetryPolicy(base_backoff_s=0.0))
    with te.injected(te.FaultInjector(seed=7, sites={
            "kernel": te.FaultSpec(at=(1,))})):
        o = svc._run_with_recovery(te.JoinQuery(b, p, query_id=4))
    assert np.array_equal(o.result.valid_pairs(), exp)
    assert [e["what"] for e in svc.metrics.events("recovery")] == ["retry"]


@pytest.mark.parametrize("n", [0, 1, 255, 257, 64 * 256 + 1, 2**16 + 3,
                               1_000_003, (1 << 24) - 5])
@pytest.mark.parametrize("kind", ["arange", "random"])
def test_sha1_tree_kernel_matches_plain(dev, n, kind):
    """The tree's top digests on the card equal the plain tree's bit for
    bit, for columns 16-byte aligned (fresh tensors) and a view that
    starts 4 bytes into a larger one; one launch a level."""
    rng = np.random.default_rng(n)
    key = (np.arange(n, dtype=np.int32) if kind == "arange" else
           rng.integers(-2**31, 2**31 - 1, n).astype(np.int32))
    rid = rng.permutation(n).astype(np.int32)
    want = ksha.tree_tops_plain([torch.from_numpy(key),
                                 torch.from_numpy(rid)])
    k = torch.from_numpy(key).to(dev)
    wide = torch.from_numpy(np.concatenate([[7], rid]).astype(np.int32))
    for cols in ([k, torch.from_numpy(rid).to(dev)], [k, wide.to(dev)[1:]]):
        reset_launch_counts()
        got = ksha.tree_tops(cols)
        assert launch_counts()["sha1_tree"] == \
            len(ksha.level_sizes(cols[0].nbytes))
        assert got.device == dev and torch.equal(got.cpu(), want)


def test_sha1_tree_wrapper_rejects_bad_inputs(dev):
    col = torch.zeros(64, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        ksha.tree_tops([col[::2]])
    with pytest.raises(ValueError):
        ksha.tree_tops([col, col.cpu()])
    with pytest.raises(ValueError):
        ksha.tree_tops([torch.zeros(3, dtype=torch.int16, device=dev)])


def test_service_on_card_keys_content_equal_pairs_alike(dev):
    """A CUDA service keys a regenerated, content-equal pair as the first
    (its partition layouts hit on both sides); the ledger's fingerprint
    bytes are the top digests pulled; ``sha1_tree`` launches on a memo
    miss and not on a hit; the spans and the counter say ``device``."""
    import repro_torch.engine as te
    from repro_torch.engine import table_cache

    cp = tc.CoProcessor(c_device="cpu", g_device=dev)
    planner = te.QueryPlanner(cache_bytes=1 << 10, rand_penalty=8.0,
                              phj_overhead_s=0.0)
    svc = te.JoinQueryService(cp=cp, planner=planner, num_workers=0)
    n = 1 << 15

    def pair():
        return (tc.uniform_relation(n, seed=1, device=dev),
                tc.uniform_relation(n, seed=2, device=dev))

    b, p = pair()
    exp = tc.join_oracle(b, p)
    digests = sum(ksha.tree_tops([r.key, r.rid]).nbytes for r in (b, p))
    assert digests == 2 * 2 * ksha.top_nbytes(4 * n)
    reset_launch_counts()
    outs = [svc.execute(te.JoinQuery(b, p, query_id=0))]
    first = launch_counts()["sha1_tree"]
    assert first == 2 * len(ksha.level_sizes(4 * n))
    assert svc.ledger.by_cause()["fingerprint"] == digests
    outs.append(svc.execute(te.JoinQuery(b, p, query_id=1)))
    assert launch_counts()["sha1_tree"] == first            # memo hits
    b2, p2 = pair()
    assert table_cache.relation_fingerprint(b2, 0) == \
        table_cache.relation_fingerprint(b, 0) != \
        table_cache.host_fingerprint(b, 0)
    reset_launch_counts()
    outs.append(svc.execute(te.JoinQuery(b2, p2, query_id=2)))
    assert launch_counts()["sha1_tree"] == first            # two misses
    assert svc.ledger.by_cause()["fingerprint"] == 2 * digests
    assert [o.plan.algorithm for o in outs] == ["phj"] * 3
    assert [(o.partition_cache_hit, o.probe_partition_cache_hit)
            for o in outs] == [(False, False), (True, True), (True, True)]
    for o in outs:
        assert np.array_equal(o.result.valid_pairs(), exp)
    missed = [s for s in svc.tracer.spans()
              if s.name == "fingerprint" and s.attrs["memo"] == "miss"]
    assert len(missed) == 4 and {s.attrs["path"] for s in missed} == \
        {"device"}
    assert svc.metrics.counter_series("fingerprints") == {
        (("path", "device"),): 4}
    svc.close()


def _views(src, seen=None):
    """Every view reachable from a pipeline result's source view."""
    from repro_torch.queries.executor import StageView
    seen = [] if seen is None else seen
    if any(src is s for s in seen):
        return seen
    seen.append(src)
    if isinstance(src, StageView):
        _views(src._psrc, seen)
        _views(src._bsrc, seen)
    return seen


@pytest.mark.parametrize("handoff", ["device", "host"])
def test_pipeline_on_card_is_exact_and_resident(dev, handoff):
    """Star and analytic queries at a 2^18 fact table through
    ``PipelineExecutor`` on the card: exact against ``reference_execute``;
    every stage relation handed to the service, every ``StageView``'s
    match vectors and every device column on ``cuda``; on the fused path
    no intermediate or fingerprint byte crosses to the host; each
    ``wall_s`` covers the synchronized phases of its stages."""
    import repro_torch.engine as te
    import repro_torch.queries as tq
    from repro_torch.queries.executor import StageView

    cp = tc.CoProcessor(c_device="cpu", g_device=dev)
    svc = te.JoinQueryService(cp=cp, num_workers=2)
    handed = []
    for name in ("execute", "submit"):
        orig = getattr(svc, name)

        def spy(q, *a, _orig=orig, **kw):
            handed.append(q)
            return _orig(q, *a, **kw)

        setattr(svc, name, spy)
    opt = tq.JoinOrderOptimizer(svc.planner, handoff=handoff)
    ex = tq.PipelineExecutor(service=svc, optimizer=opt, handoff=handoff)
    gen = te.WorkloadGenerator(1 << 17, seed=42, device=dev)
    queries = [tq.make_star_query(1 << 18, [1 << 15] * 3,
                                  selectivities=[0.02, None, 0.5], seed=17)]
    queries += [gen.analytic() for _ in range(4)]
    reset_launch_counts()
    for q in queries:
        res = ex.run(q)
        ref_rows, ref_agg = tq.reference_execute(q)
        assert res.aggregate == ref_agg
        assert np.array_equal(res.rows_array(), ref_rows), q.describe()
        assert res.wall_s >= sum(sum(o.timing.phase_s.values())
                                 for o in res.outcomes) > 0
        if handoff == "device":
            assert res.host_bytes_moved == 0
            src = res._source
            if isinstance(src, StageView):
                for v in _views(src):
                    if isinstance(v, StageView):
                        assert v._pr.device.type == "cuda"
                        assert v._br is None or v._br.device.type == "cuda"
                        memo = v._col_memo
                    else:
                        memo = v._dev_memo
                    assert all(c.device.type == "cuda"
                               for c in memo.values())
    counts = launch_counts()
    assert counts["hash_bucket"] > 0 and counts["seg_agg"] > 0
    for q in handed:
        rels = ((q.build, q.probe) if isinstance(q, te.JoinQuery)
                else (q.keys,))
        for r in rels:
            assert r.rid.device.type == r.key.device.type == "cuda", q.tag
    by_cause = svc.ledger.by_cause()
    assert by_cause["fingerprint"] == 0
    if handoff == "device":
        assert by_cause["handoff"] == 0
        assert svc.stats()["host_bytes_moved"] == 0
    svc.close()


@pytest.mark.parametrize("schedule,pr,ar", [
    (None, 0.0, 0.0), (None, 0.5, 0.5), ((7, 6), 0.25, 0.4)])
def test_groupby_int64_on_card_equals_cpu(dev, schedule, pr, ar):
    """Int64 values (a query's expression) through ``seg_agg`` as two
    int32 words: the card's exact sums equal the CPU's, bit for bit."""
    n = 1 << 16
    rng = np.random.default_rng(9)
    keys = rng.integers(0, n // 64, n).astype(np.int32)
    vals = _ints(rng, n).astype(np.int64) * rng.integers(-2**24, 2**24, n)
    rel = tc.Relation(torch.arange(n, dtype=torch.int32),
                      torch.from_numpy(keys))
    kw = dict(schedule=schedule, partition_ratio=pr, agg_ratio=ar)
    want, _ = tc.CoProcessor("cpu", "cpu").groupby(
        rel, torch.from_numpy(vals), **kw)
    reset_launch_counts()
    got, _ = tc.CoProcessor("cpu", dev).groupby(
        rel.to(dev), torch.from_numpy(vals).to(dev), **kw)
    assert launch_counts()["seg_agg"] >= 2
    for f in ("keys", "counts", "sums"):
        w, g = getattr(want, f), getattr(got, f)
        assert w.dtype == g.dtype and np.array_equal(w, g), f
    assert np.array_equal(got.sorted().sums,
                          tops.groupby_ref(keys, vals).sums)


@pytest.mark.parametrize("group_by", [(), ("F.g",), ("F.g", "D0.a")])
def test_expression_sums_on_card_are_exact(dev, group_by):
    """A sum of ``F.m * D1.a``-style products past int32 at a 2^18 fact
    table through ``PipelineExecutor`` on the card, scalar and grouped:
    exact against ``reference_execute``, with no operand pulled to the
    host (only the group keys, for multi-column packing)."""
    import repro_torch.engine as te
    import repro_torch.queries as tq

    base = tq.make_star_query(1 << 18, [1 << 15] * 2,
                              selectivities=[0.5, None], seed=23)
    rng = np.random.default_rng(4)
    fact = dict(base.tables["F"].columns,
                x=_ints(rng, 1 << 18), y=_ints(rng, 1 << 18, -2**20, 2**20))
    tables = dict(base.tables, F=tq.Table("F", fact))
    svc = te.JoinQueryService(cp=tc.CoProcessor(c_device="cpu", g_device=dev),
                              num_workers=2)
    ex = tq.PipelineExecutor(service=svc)
    try:
        for op, a, b in (("*", "F.x", "F.y"), ("-", "F.x", "D1.a"),
                         ("+", "F.y", "D0.a")):
            q = tq.Query(tables=tables, joins=base.joins,
                         aggregate=("sum", (op, a, b)), group_by=group_by)
            before = svc.ledger.by_cause()
            res = ex.run(q)
            moved = {k: v - before.get(k, 0)
                     for k, v in svc.ledger.by_cause().items()}
            rows, agg = tq.reference_execute(q)
            assert res.aggregate == agg
            assert np.array_equal(res.rows_array() if group_by else
                                  rows, rows)
            assert moved["result"] == 0 or group_by
            assert moved["multicol_pack"] <= (
                4 * 2 * (1 << 18) * 2 if len(group_by) > 1 else 0)
    finally:
        svc.close()


def test_run_map_series_on_card_matches_one_device(dev):
    """``run_map_series`` over ``partition_series(0)`` with the C group on
    the host and the G group on the card, the ratio moving across n1-n3:
    each group's items equal one-device ``run_series`` over its slice,
    the combined histogram the whole relation's, and the boundary moves
    counted as the JAX package counts them."""
    from repro_torch.core.steps import run_series

    n = 1 << 18
    rng = np.random.default_rng(5)
    items = {"rid": torch.from_numpy(rng.permutation(n).astype(np.int32)),
             "key": torch.from_numpy(rng.integers(0, 1 << 30, n)
                                     .astype(np.int32))}
    shared = {"shift": 0, "bits": 8}
    series = tc.partition_series(0)
    for discrete in (False, True):
        cp = tc.CoProcessor(c_device="cpu", g_device=dev,
                            discrete=discrete, link=tc.PCIE_LINK)
        ratios = (0.25, 0.0, 0.5)
        reset_launch_counts()
        out_c, out_g, extra, timing = cp.run_map_series(series, shared,
                                                        items, ratios)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert counts["hash_bucket"] == 1 and counts["radix_hist"] == 1
        cut = cp._cut(n, ratios[-1])
        assert out_c["key"].device.type == "cpu"
        assert out_g["key"].device.type == "cuda"
        want_c, _ = run_series(series, shared,
                               {k: v[:cut] for k, v in items.items()})
        want_g, _ = run_series(series, shared,
                               {k: v[cut:] for k, v in items.items()})
        for k in ("rid", "key"):
            assert torch.equal(out_c[k], want_c[k])
            assert torch.equal(out_g[k].cpu(), want_g[k])
        _, whole = run_series(series, shared, items)
        assert torch.equal(extra["part_hist"], whole["part_hist"])
        # Two boundary moves of (rid, key, pid), 12 bytes an item.
        moved = 12 * (cp._cut(n, 0.25) + cut)
        assert timing.transfer_bytes == moved + (
            8 * (n - cp._cut(n, 0.25)) if discrete else 0)


@pytest.mark.parametrize("impl", ["dense", "sorted"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_sorted_on_card_matches_cpu(dev, monkeypatch, impl,
                                        capacity_factor):
    """A reduced granite E block in float32: the card's engine (``sorted``
    launches E once) against the CPU port, routes, expert buffers (which
    pairs each expert kept, in which slot) and output to 2e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tconfigs.reduced(tconfigs.get_config("granite_moe_3b"))
    cfg = dataclasses.replace(cfg, dtype="float32", moe_impl=impl,
                              moe=dataclasses.replace(
                                  cfg.moe, capacity_factor=capacity_factor))
    params = tparams.materialize(tmoe.moe_specs(cfg),
                                 torch.Generator().manual_seed(3),
                                 torch.float32)
    x = torch.randn(4, 96, cfg.d_model,
                    generator=torch.Generator().manual_seed(4))

    def run(device):
        seen = []
        route, ffn = tmoe._route, tmoe._experts_ffn
        monkeypatch.setattr(tmoe, "_route", lambda *a: seen.append(
            route(*a)) or seen[-1])
        monkeypatch.setattr(tmoe, "_experts_ffn", lambda p, e: seen.append(
            e) or ffn(p, e))
        p = {k: v.to(device) for k, v in params.items()}
        y, aux = tmoe.moe(p, cfg, x.to(device))
        monkeypatch.setattr(tmoe, "_route", route)
        monkeypatch.setattr(tmoe, "_experts_ffn", ffn)
        (idx, w, probs), buf = seen
        return [t.cpu() for t in (y, aux, idx, w, probs, buf)]

    reset_launch_counts()
    got = run(dev)
    assert launch_counts()["radix_hist"] == (impl == "sorted")
    want = run("cpu")
    assert torch.equal(got[2], want[2])                     # routes
    assert torch.equal(got[5] != 0, want[5] != 0)           # kept slots
    for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert torch.allclose(g, w, rtol=2e-5, atol=2e-5)


# -- training: G's and H's autograd Functions, and the train step -------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", GRID_G)
def test_flash_attention_function_grads_match_plain_backward(
        dev, b, sq, sk, h, kv, d, causal, dtype, tol):
    """G forward (the kernel) with the blockwise plain backward against
    autograd through the whole plain version: dq, dk, dv within ``tol``
    in RMS(diff) / RMS; the backward launches no kernel."""
    from repro_torch.kernels.flash_attn import ops as gops

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(sq + d + 1)
    ins = [torch.randn(b, s, n, d, generator=g, device=dev).to(dtype)
           for s, n in ((sq, h), (sk, kv), (sk, kv))]
    go = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
    got = [t.clone().requires_grad_() for t in ins]
    n0 = launch_counts()["flash_attn"]
    gops.flash_attention(*got, num_kv_heads=kv, causal=causal).backward(go)
    assert launch_counts()["flash_attn"] == n0 + 1
    want = [t.clone().requires_grad_() for t in ins]
    fa.flash_attention_plain(*want, num_kv_heads=kv,
                             causal=causal).backward(go)
    for x, y in zip(got, want):
        assert x.grad.dtype == dtype and torch.isfinite(x.grad).all()
        rel = float((x.grad.float() - y.grad.float()).norm()
                    / y.grad.float().norm().clamp_min(1e-30))
        assert rel < tol, rel


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 1e-6)])
@pytest.mark.parametrize("bs,nc,q,h,p,n", GRID_H)
def test_ssd_intra_chunk_function_grads_match_plain_backward(
        dev, bs, nc, q, h, p, n, dtype, tol):
    """H forward (the kernel) with its plain backward against autograd
    through the plain version: the gradients of all five inputs (the
    backward recomputes that same version, so they agree to rounding)."""
    from repro_torch.kernels.ssd import ops as hops

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(q + n + 1)
    ins = [torch.randn(bs, nc, q, h, p, generator=g, device=dev).to(dtype),
           torch.rand(bs, nc, q, h, generator=g, device=dev) * 0.19 + 0.01,
           torch.randn(bs, nc, q, n, generator=g, device=dev).to(dtype),
           torch.randn(bs, nc, q, n, generator=g, device=dev).to(dtype),
           -torch.exp(torch.randn(h, generator=g, device=dev) * 0.3)]
    gy = torch.randn(bs, nc, q, h, p, generator=g, device=dev)
    got = [t.clone().requires_grad_() for t in ins]
    n0 = launch_counts()["ssd_intra_chunk"]
    hops.ssd_intra_chunk(*got).backward(gy)
    assert launch_counts()["ssd_intra_chunk"] == n0 + 1
    want = [t.clone().requires_grad_() for t in ins]
    kssd.ssd_intra_chunk_plain(*want).backward(gy)
    for x, y in zip(got, want):
        assert x.grad.dtype == x.dtype and torch.isfinite(x.grad).all()
        rel = float((x.grad.float() - y.grad.float()).norm()
                    / y.grad.float().norm().clamp_min(1e-30))
        assert rel < tol, rel


def test_train_step_on_card_matches_cpu(dev):
    """Reduced Zamba2 in float32 under remat "full", two microbatches a
    step: three steps of ``make_train_step`` on the card (G and H
    kernels, each unit's twice) against the same on the CPU."""
    import dataclasses

    from repro_torch.configs import ShapeSpec
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(
        tconfigs.reduced(tconfigs.get_config("zamba2_1_2b")),
        dtype="float32", remat="full")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, None, None, opt, accum_steps=2)
    cpu = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    card = tfm.init_params(cfg, torch.Generator().manual_seed(0)).to(dev)
    sc, sg = adamw_init(cpu, opt), adamw_init(card, opt)
    shape = ShapeSpec("t", 64, 4, "train")
    for i in range(3):
        cpu, sc, mc = step(cpu, sc, make_batch(cfg, shape, i, device="cpu"))
        reset_launch_counts()
        card, sg, mg = step(card, sg, make_batch(cfg, shape, i, device=dev))
        counts = launch_counts()
        assert counts["flash_attn"] == 2 * 2 and \
            counts["ssd_intra_chunk"] == 2 * (2 * 5 + 2), counts
        for k in ("loss", "grad_norm", "lr"):
            assert abs(float(mg[k]) - float(mc[k])) <= \
                1e-4 * abs(float(mc[k])), (i, k)
        for a, b in zip(cpu.parameters(), card.parameters()):
            rel = float((b.detach().cpu() - a.detach()).norm()
                        / a.detach().norm().clamp_min(1e-30))
            assert rel < 1e-3, (i, rel)
