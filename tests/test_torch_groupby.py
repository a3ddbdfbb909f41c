"""Port parity for the co-processed group-by slice: kernel C's plain
version (``seg_agg``) against the JAX package's Pallas kernel in interpret
mode and its jnp reference, ``grouped_agg`` and ``CoProcessor.groupby``
against ``repro.ops`` on the same NumPy data, bit for bit and row for
row."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import repro.ops as jops
import repro_torch.core as tc
import repro_torch.ops as tops
from repro.kernels.agg import agg as jagg
from repro.kernels.agg.ref import seg_agg_ref as j_seg_agg_ref
from repro_torch.kernels.agg import agg as tagg
from repro_torch.kernels.agg.ops import segmented_aggregate
from repro_torch.kernels.agg.ref import seg_agg_ref

from _torch_parity import relation


def _same(want, got):
    """A JAX output tuple and a port output tuple, leaf by leaf."""
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        w, g = np.asarray(w), g.numpy()
        assert w.shape == g.shape and w.dtype == g.dtype, (i, w.shape,
                                                           g.shape)
        assert np.array_equal(w, g), i


def _agg_inputs(n, slots, seed):
    """gids with -1s and ids >= slots; values over the whole int32 range."""
    rng = np.random.default_rng(seed)
    gid = rng.integers(-1, slots + max(1, slots // 4), n).astype(np.int32)
    val = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    val[:2] = [-2**31, 2**31 - 1]
    return gid, val


@pytest.mark.parametrize("wrap32", [False, True])
@pytest.mark.parametrize("n,slots", [(1024, 16), (2048, 128), (8192, 1024)])
def test_seg_agg_matches_pallas_and_ref(n, slots, wrap32):
    gid, val = _agg_inputs(n, slots, seed=n + slots)
    got = tagg.seg_agg(torch.from_numpy(gid), torch.from_numpy(val),
                       num_slots=slots, wrap32=wrap32)
    jg, jv = jnp.asarray(gid), jnp.asarray(val)
    _same(jagg.seg_agg_pallas(jg, jv, num_slots=slots, interpret=True,
                              wrap32=wrap32), got)
    _same(j_seg_agg_ref(jg, jv, num_slots=slots, wrap32=wrap32), got)


@pytest.mark.parametrize("wrap32", [False, True])
def test_seg_agg_ragged_matches_ref(wrap32):
    gid, val = _agg_inputs(5000, 300, seed=5)
    got = segmented_aggregate(torch.from_numpy(gid), torch.from_numpy(val),
                              num_slots=300, wrap32=wrap32)
    _same(j_seg_agg_ref(jnp.asarray(gid), jnp.asarray(val), num_slots=300,
                        wrap32=wrap32), got)
    assert all(torch.equal(a, b) for a, b in zip(got, seg_agg_ref(
        torch.from_numpy(gid), torch.from_numpy(val), num_slots=300,
        wrap32=wrap32)))


def test_seg_agg_all_pads_reports_neutral_slots():
    gid = np.full(1024, -1, np.int32)
    val = np.arange(1024, dtype=np.int32)
    got = tagg.seg_agg(torch.from_numpy(gid), torch.from_numpy(val),
                       num_slots=8)
    _same(jagg.seg_agg_pallas(jnp.asarray(gid), jnp.asarray(val),
                              num_slots=8, interpret=True), got)
    assert got[2].tolist() == [tagg.INT32_MAX] * 8


def test_wide_chunk_widths_match_reference():
    cap8, cap6, cap4 = ((2**31 - 1) // 255, (2**31 - 1) // 63,
                        (2**31 - 1) // 15)
    assert cap8 == 8_421_504 == tagg.WIDE_SUM_MAX_ROWS
    for n in (0, 1, 4096, cap8, cap8 + 1, 1 << 24, cap6, cap6 + 1, cap4):
        assert tagg.wide_chunk_bits(n) == jagg.wide_chunk_bits(n), n
    assert tagg.wide_chunk_bits(1 << 24) == 6
    assert tagg.sum_rows(1 << 24, False) == 7
    assert [tagg._num_chunks(b) for b in (8, 6, 4)] == \
        [jagg._num_chunks(b) for b in (8, 6, 4)] == [4, 6, 8]
    for n in (cap4 + 1, 1 << 31):
        with pytest.raises(ValueError):
            jagg.wide_chunk_bits(n)
        with pytest.raises(ValueError, match="wrap32"):
            tagg.wide_chunk_bits(n)
    # The dispatcher raises before touching any data.
    big = torch.empty(cap4 + 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="wrap32"):
        segmented_aggregate(big, big, num_slots=4)


@pytest.mark.parametrize("rows", [5, 7, 9])
def test_wide_sum_decode_matches_reference(rows):
    bits = {5: 8, 7: 6, 9: 4}[rows]
    rng = np.random.default_rng(rows)
    sm = rng.integers(0, 2**31, (rows, 64), dtype=np.int64).astype(np.int32)
    sm[:-1] &= np.int32(((1 << bits) - 1) * 0x3FFFFF)
    want = jagg.wide_sums_to_int64(sm)
    assert np.array_equal(tagg.wide_sums_to_int64(sm), want)
    assert np.array_equal(
        tagg.wide_sums_to_int64_tensor(torch.from_numpy(sm)).numpy(), want)


def _group_rel(n, seed, pads=0):
    """Keys with negatives (the pad key -4 among them); the last ``pads``
    rows are pad tuples (rid INVALID)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-40, 200, n).astype(np.int32)
    keys[:3] = [-4, -1, 2**31 - 1]
    rids = np.arange(n, dtype=np.int32)
    rids[n - pads:] = -1
    vals = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    return keys, rids, vals


@pytest.mark.parametrize("wrap32", [False, True])
@pytest.mark.parametrize("n,pads", [(1024, 0), (3000, 17), (4096, 100)])
def test_grouped_agg_matches(n, pads, wrap32):
    keys, rids, vals = _group_rel(n, seed=n, pads=pads)
    jrel, trel = relation(keys, rids)
    want = jops.grouped_agg(jrel, jnp.asarray(vals), num_slots=n,
                            wrap32=wrap32, interpret=n == 1024)
    got = tops.grouped_agg(trel, torch.from_numpy(vals), num_slots=n,
                           wrap32=wrap32)
    _same(want, got)


@pytest.fixture(scope="module")
def coprocessors():
    return jc.CoProcessor(), tc.CoProcessor(c_device="cpu", g_device="cpu")


def _same_result(want, got):
    """Two GroupByResults equal row for row, dtypes included."""
    for f in ("keys", "counts", "sums", "mins", "maxs"):
        w, g = getattr(want, f), getattr(got, f)
        assert w.dtype == g.dtype, (f, w.dtype, g.dtype)
        assert np.array_equal(w, g), f


def _groupby_both(coprocessors, keys, vals, **kw):
    jcp, tcp_ = coprocessors
    jrel, trel = relation(keys)
    want, jt = jcp.groupby(jrel, vals, **kw)
    got, tt = tcp_.groupby(trel, vals, **kw)
    _same_result(want, got)
    ref = tops.groupby_ref(keys, vals, wrap32=kw.get("wrap32", False))
    _same_result(ref, got.sorted())
    return got, jt, tt


@pytest.mark.parametrize("schedule,pr,ar,n", [
    ((3, 2), 0.5, 0.5, 4096), ((4,), 1.0, 0.25, 4096),
    (None, 1.0, 1.0, 4096), (None, 0.0, 0.0, 4096),
    (None, 0.5, 0.5, 4096), ((7, 6), 0.25, 0.4, 8192)])
def test_coprocessed_groupby_matches(coprocessors, schedule, pr, ar, n):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 64 if n == 4096 else 2048, n).astype(np.int32)
    vals = rng.integers(0, 100, n).astype(np.int32)
    _, jt, tt = _groupby_both(coprocessors, keys, vals, schedule=schedule,
                              partition_ratio=pr, agg_ratio=ar)
    assert set(tt.phase_s) == {"partition", "agg"}
    assert tt.wall_s == tt.phase_s["partition"] + tt.phase_s["agg"]
    assert tt.notes == jt.notes
    if schedule:
        assert tt.phase_s["partition"] > 0


def test_groupby_edge_cases(coprocessors):
    jcp, tcp_ = coprocessors
    empty_j, empty_t = relation(np.zeros(0, np.int32))
    want, _ = jcp.groupby(empty_j, np.zeros(0, np.int32))
    got, t = tcp_.groupby(empty_t, np.zeros(0, np.int32),
                          partition_ratio=1.0, agg_ratio=1.0)
    _same_result(want, got)
    assert got.num_groups == 0 and t.phase_s == {"partition": 0.0,
                                                 "agg": 0.0}
    n = 1024
    keys, vals = np.full(n, 7, np.int32), np.arange(n, dtype=np.int32)
    got, _, _ = _groupby_both(coprocessors, keys, vals, schedule=(2,),
                              partition_ratio=0.5, agg_ratio=0.5)
    assert got.num_groups == 1 and int(got.counts[0]) == n
    assert int(got.mins[0]) == 0 and int(got.maxs[0]) == n - 1


@pytest.mark.parametrize("wrap32,ar", [(False, 1.0), (True, 1.0),
                                       (False, 0.5), (True, 0.5)])
def test_groupby_sum_width_modes(coprocessors, wrap32, ar):
    n = 1024
    keys, vals = np.zeros(n, np.int32), np.full(n, 2**30, np.int32)
    got, _, _ = _groupby_both(coprocessors, keys, vals, partition_ratio=1.0,
                              agg_ratio=ar, wrap32=wrap32)
    assert got.sums.dtype == (np.int32 if wrap32 else np.int64)
    if not wrap32:
        assert int(got.sums[0]) == n * 2**30


@pytest.mark.parametrize("schedule,pr,ar", [((3,), 0.5, 0.5),
                                            (None, 0.5, 0.5),
                                            (None, 0.0, 0.0)])
def test_groupby_discrete_bus(schedule, pr, ar):
    keys = np.random.default_rng(2).integers(0, 100, 2048).astype(np.int32)
    vals = np.arange(2048, dtype=np.int32)
    cps = (jc.CoProcessor(link=jc.PCIE_LINK, discrete=True),
           tc.CoProcessor(c_device="cpu", g_device="cpu", link=tc.PCIE_LINK,
                          discrete=True))
    _, jt, tt = _groupby_both(cps, keys, vals, schedule=schedule,
                              partition_ratio=pr, agg_ratio=ar)
    assert tt.transfer_bytes == jt.transfer_bytes > 0
    assert tt.transfer_s > 0


class _Ctx:
    """A QueryContext stand-in: records checks, aborts at one of them."""

    def __init__(self, stop_at=None):
        self.stop_at = stop_at
        self.checks, self.partial = [], {}

    def check(self, where):
        self.checks.append(where)
        if where == self.stop_at:
            raise TimeoutError(where)

    def note_partial(self, tag, rel, passes):
        self.partial[tag] = (rel, passes)


@pytest.mark.parametrize("stop_at", [None, "partition:GB:pass1", "agg"])
def test_groupby_ctx_checks_match(coprocessors, stop_at):
    jcp, tcp_ = coprocessors
    keys = np.random.default_rng(4).integers(0, 300, 4096).astype(np.int32)
    vals = np.arange(4096, dtype=np.int32)
    jrel, trel = relation(keys)
    kw = dict(schedule=(3, 2, 2), partition_ratio=0.25, agg_ratio=0.4)
    jctx, tctx = _Ctx(stop_at), _Ctx(stop_at)
    if stop_at is None:
        want, _ = jcp.groupby(jrel, vals, ctx=jctx, **kw)
        got, _ = tcp_.groupby(trel, vals, ctx=tctx, **kw)
        _same_result(want, got)
    else:
        with pytest.raises(TimeoutError):
            jcp.groupby(jrel, vals, ctx=jctx, **kw)
        with pytest.raises(TimeoutError):
            tcp_.groupby(trel, vals, ctx=tctx, **kw)
    assert tctx.checks == jctx.checks and len(tctx.checks) >= 1
    assert set(tctx.partial) == set(jctx.partial)
    for tag, (rel, passes) in tctx.partial.items():
        jrel_p, jpasses = jctx.partial[tag]
        assert passes == jpasses
        assert np.array_equal(rel.key.numpy(), np.asarray(jrel_p.key))
        assert np.array_equal(rel.rid.numpy(), np.asarray(jrel_p.rid))


def test_groupby_takes_a_value_tensor(coprocessors):
    keys = np.random.default_rng(6).integers(0, 50, 2048).astype(np.int32)
    vals = np.random.default_rng(7).integers(-9, 9, 2048).astype(np.int32)
    _, trel = relation(keys)
    kw = dict(schedule=(2, 2), partition_ratio=0.5, agg_ratio=0.5)
    a, _ = coprocessors[1].groupby(trel, vals, **kw)
    b, _ = coprocessors[1].groupby(trel, torch.from_numpy(vals), **kw)
    _same_result(a, b)


def test_groupby_ratios_are_required(coprocessors):
    _, trel = relation(np.zeros(8, np.int32))
    with pytest.raises(TypeError, match="partition_ratio"):
        coprocessors[1].groupby(trel, np.zeros(8, np.int32))
    with pytest.raises(TypeError, match="agg_ratio"):
        coprocessors[1].groupby(trel, np.zeros(8, np.int32),
                                partition_ratio=0.0)
