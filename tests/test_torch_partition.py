"""Port parity: radix partitioning (repro_torch.core.partition and the
kernels' plain versions) against repro.core.partition and the Pallas
kernels in interpret mode, bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
from repro.core.partition import radix_partition_cooperative as j_coop
from repro.core.pass_planner import default_planner as j_default_planner
from repro.kernels.partition_hist.fused import partition_hist_fused_pallas
from repro.kernels.partition_hist.ops import fused_partition_pass as j_pass
from repro.kernels.partition_hist.reorder import radix_scatter_pallas
from repro_torch.core.partition import radix_partition_cooperative as t_coop
from repro_torch.core.pass_planner import default_planner as t_default_planner
from repro_torch.kernels.partition_hist import ref as tref
from repro_torch.kernels.partition_hist.ops import fused_partition_pass

from _torch_parity import assert_same, relation


def _rel(rng, n, lo=-3):
    """Keys with the negative pad sentinels and the int32 extremes."""
    keys = rng.integers(lo, 2**31 - 1, n, dtype=np.int64)
    keys[: min(n, 4)] = [-2, -3, 2**31 - 1, 0][: min(n, 4)]
    return relation(keys.astype(np.int32),
                    rng.permutation(n).astype(np.int32))


@pytest.mark.parametrize("n,shift,bits", [(1024, 0, 1), (1024, 3, 4),
                                          (4096, 5, 8), (8192, 9, 4),
                                          (2048, 24, 8)])
def test_fused_pass_matches_interpret_pallas(n, shift, bits, rng):
    jr, tr = _rel(rng, n)
    want = j_pass(jr, shift=shift, bits=bits, interpret=True)
    got = fused_partition_pass(tr, shift=shift, bits=bits)
    assert_same(want, got)


@pytest.mark.parametrize("n,shift,bits", [(1, 0, 1), (1000, 2, 1),
                                          (3001, 7, 4), (8191, 11, 8),
                                          (5000, 0, 16)])
def test_fused_pass_matches_jnp_path(n, shift, bits, rng):
    jr, tr = _rel(rng, n)
    want = j_pass(jr, shift=shift, bits=bits, use_pallas=False)
    got = fused_partition_pass(tr, shift=shift, bits=bits)
    assert_same(want, got)


@pytest.mark.parametrize("n,shift,bits", [(1024, 0, 1), (4096, 7, 6),
                                          (8192, 2, 8)])
def test_plain_kernels_match_pallas_kernels(n, shift, bits, rng):
    jr, tr = _rel(rng, n)
    pid, hist = partition_hist_fused_pallas(jr.key, shift=shift, bits=bits,
                                            interpret=True)
    tpid, thist = tref.partition_hist_fused_ref(tr.key, shift=shift,
                                                bits=bits)
    assert_same((pid, hist), (tpid, thist))
    assert_same(hist, [tref.radix_hist_ref(tpid, num_parts=1 << bits)])
    starts = jnp.cumsum(hist) - hist
    want = radix_scatter_pallas(jr.rid, jr.key, pid, starts.astype(jnp.int32),
                                num_parts=1 << bits, interpret=True)
    tstarts = torch.cumsum(thist, 0, dtype=torch.int32) - thist
    got = tref.radix_scatter_ref(tr.rid, tr.key, tpid, tstarts,
                                 num_parts=1 << bits)
    assert_same(want, got)


PLANNED_NS = [1 << 12, 1 << 22, 1 << 24]


@pytest.mark.parametrize("n", PLANNED_NS)
def test_planner_matches(n):
    want = j_default_planner().plan(n)
    got = t_default_planner().plan(n)
    assert got.schedule == want.schedule
    assert got.est_s == pytest.approx(want.est_s, rel=1e-12)
    assert (tc.resolve_schedule(n, num_passes=3)
            == jc.resolve_schedule(n, num_passes=3))


def _planned_schedules():
    return sorted({j_default_planner().plan(n).schedule for n in PLANNED_NS}
                  | {(4, 3, 3)})


@pytest.mark.parametrize("sched", _planned_schedules())
def test_scheduled_partition_matches(sched, rng):
    jr, tr = _rel(rng, 8192)
    want = jc.radix_partition_scheduled(jr, schedule=sched)
    got = tc.radix_partition_scheduled(tr, schedule=sched)
    assert_same(want, got)
    assert got.num_partitions == 1 << sum(sched)


@pytest.mark.parametrize("sched", [s for s in _planned_schedules()
                                   if len(s) > 1])
def test_cooperative_resume_matches(sched, rng):
    jr, tr = _rel(rng, 4096)
    # A partial layout holding the first pass, resumed at pass 1.
    jpart = jc.partition.partition_pass(jr, shift=0, bits=sched[0])
    tpart = tc.partition.partition_pass(tr, shift=0, bits=sched[0])
    assert_same(jpart, tpart)
    seen = []
    want = j_coop(jpart, schedule=sched, start_pass=1)
    got = t_coop(tpart, schedule=sched, start_pass=1, check=seen.append)
    assert_same(want, got)
    assert seen == list(range(1, len(sched)))
    assert_same(jc.radix_partition_scheduled(jr, schedule=sched), got)


def test_cooperative_check_aborts_between_passes(rng):
    _, tr = _rel(rng, 1024)

    def check(i):
        if i == 1:
            raise TimeoutError(i)
    with pytest.raises(TimeoutError):
        t_coop(tr, schedule=(3, 3), check=check)


@pytest.mark.parametrize("bits_per_pass,num_passes", [(3, 2), (5, 1)])
def test_uniform_and_unfused_match(bits_per_pass, num_passes, rng):
    jr, tr = _rel(rng, 4096)
    kw = dict(bits_per_pass=bits_per_pass, num_passes=num_passes)
    assert_same(jc.radix_partition(jr, **kw), tc.radix_partition(tr, **kw))
    assert_same(jc.radix_partition_unfused(jr, **kw),
                tc.radix_partition_unfused(tr, **kw))
    assert_same(jc.partition.partition_ids(jr, total_bits=6),
                [tc.partition.partition_ids(tr, total_bits=6)])


def test_partition_series_steps_match(rng):
    jr, tr = _rel(rng, 2048)
    shared = {"shift": 2, "bits": 5}
    ji = {"rid": jr.rid, "key": jr.key}
    ti = {"rid": tr.rid, "key": tr.key}
    for js, ts in zip(jc.partition_series(0).steps,
                      tc.partition_series(0).steps):
        assert js.name == ts.name
        assert dataclasses.astuple(js.cost) == dataclasses.astuple(ts.cost)
        ji, jsh = js.apply(shared, ji)
        ti, tsh = ts.apply(shared, ti)
        assert_same([ji[k] for k in sorted(ji)], [ti[k] for k in sorted(ti)])
        assert_same([jsh[k] for k in sorted(jsh)],
                    [tsh[k] for k in sorted(tsh)])


@pytest.mark.parametrize("shift,bits", [(0, 0), (0, 33), (20, 13), (-1, 4)])
def test_pass_rejects_bad_digits(shift, bits):
    _, tr = relation(np.arange(64))
    with pytest.raises(ValueError):
        fused_partition_pass(tr, shift=shift, bits=bits)


@pytest.mark.parametrize("n,shift,bits", [(4096, 0, 17), (3001, 7, 18),
                                          (2048, 14, 18), (1000, 0, 20)])
def test_wide_digit_pass_matches_jnp_path(n, shift, bits, rng):
    """Digits wider than 16 bits (the reference takes any shift + bits <=
    32): pid, histogram and the stable reorder, bit for bit."""
    jr, tr = _rel(rng, n)
    want = j_pass(jr, shift=shift, bits=bits, use_pallas=False)
    got = fused_partition_pass(tr, shift=shift, bits=bits)
    assert_same(want, got)
    assert got[2].shape == (1 << bits,)


@pytest.mark.parametrize("sched", [(17,), (9, 9), (1, 17)])
def test_wide_schedules_match(sched, rng):
    jr, tr = _rel(rng, 4096)
    want = jc.radix_partition_scheduled(jr, schedule=sched)
    got = tc.radix_partition_scheduled(tr, schedule=sched)
    assert_same(want, got)
    assert got.num_partitions == 1 << sum(sched)


def test_kernel_wrappers_reject_other_devices():
    from repro_torch.kernels.partition_hist.fused import partition_hist_fused
    from repro_torch.kernels.partition_hist.reorder import radix_scatter
    meta = torch.empty(64, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        partition_hist_fused(meta, shift=0, bits=4)
    with pytest.raises(ValueError, match="unsupported device"):
        radix_scatter(meta, meta, meta,
                      torch.empty(16, dtype=torch.int32, device="meta"),
                      num_parts=16)
    cpu = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="several devices"):
        radix_scatter(cpu, cpu, meta, cpu[:16], num_parts=16)
    with pytest.raises(ValueError, match="power of two"):
        radix_scatter(cpu, cpu, cpu, cpu[:12], num_parts=12)


@pytest.mark.parametrize("bits", [1, 6, 7, 11])
def test_scatter_tiles_on_the_shared_path(bits):
    from repro_torch.kernels.partition_hist import reorder
    p = 1 << bits
    assert reorder.uses_shared(p)
    assert reorder.tile_len(p) == reorder.SHARED_TILE == 4096
    assert reorder.scratch_ints(1 << 24, p) == p * 4096
    assert reorder.scratch_ints(4097, p) == 2 * p
    assert reorder.scratch_ints(1, p) == p


@pytest.mark.parametrize("bits", [12, 13, 16])
def test_scatter_tiles_on_the_device_memory_path(bits):
    from repro_torch.kernels.partition_hist import reorder
    p = 1 << bits
    assert not reorder.uses_shared(p)
    assert reorder.tile_len(p) == 8 * p
    # The offset matrix stays at n/8 ints once n spans a tile.
    assert reorder.scratch_ints(1 << 24, p) == (1 << 24) // 8
    assert reorder.scratch_ints(5, p) == p


def test_shared_path_threshold_is_2048_partitions():
    from repro_torch.kernels.partition_hist import reorder
    assert reorder.SHARED_MAX_PARTS == 2048
    assert reorder.uses_shared(2048) and not reorder.uses_shared(4096)
