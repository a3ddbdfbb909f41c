"""Port parity for the slice as a whole: phj_join and CoProcessor.phj
(repro_torch) against repro.core on the same data, whole JoinResult bit for
bit, and against the join oracle."""
import jax
import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
from repro_torch.core import coprocess as tcp

from _torch_parity import assert_same, to_torch


def _data(kind, n=4096):
    if kind == "uniform":
        jb, jp = jc.uniform_relation(n, seed=1), jc.uniform_relation(n, seed=2)
    elif kind == "high_skew":
        jb = jc.skewed_relation(n, s_percent=25, seed=1)
        jp = jc.skewed_relation(n, s_percent=25, seed=2)
    else:  # selectivity 0.125 against a primary-key build side
        jb = jc.unique_relation(n, seed=1)
        jp = jc.probe_with_selectivity(jb, n, selectivity=0.125, seed=2)
    return jb, jp, to_torch(jb), to_torch(jp), jc.join_oracle(jb, jp)


KINDS = ["uniform", "high_skew", "selectivity"]


@pytest.mark.parametrize("sched", [None, (3, 2)])
@pytest.mark.parametrize("kind", KINDS)
def test_phj_join_matches(kind, sched):
    jb, jp, tb, tp, exp = _data(kind)
    mo = 2 * jb.size + len(exp)
    want = jc.phj_join(jb, jp, schedule=sched, max_out=mo)
    got = tc.phj_join(tb, tp, schedule=sched, max_out=mo)
    assert_same(want, got)
    assert np.array_equal(got.valid_pairs(), exp)


@pytest.mark.parametrize("sched", [(17,), (9, 9)])
def test_phj_join_wide_schedules_match(sched):
    """Radix digits wider than 16 bits: the JoinResult equals the JAX
    package's and the oracle (4160 pairs on the uniform data)."""
    jb, jp, tb, tp, exp = _data("uniform")
    want = jc.phj_join(jb, jp, schedule=sched, max_out=20000)
    got = tc.phj_join(tb, tp, schedule=sched, max_out=20000)
    assert_same(want, got)
    assert np.array_equal(got.valid_pairs(), exp)
    assert int(got.count) == len(exp) == 4160


def test_phj_join_truncates_like_reference():
    jb, jp, tb, tp, exp = _data("high_skew")
    mo = len(exp) // 3
    assert_same(jc.phj_join(jb, jp, bits_per_pass=2, num_passes=2,
                            max_out=mo),
                tc.phj_join(tb, tp, bits_per_pass=2, num_passes=2,
                            max_out=mo))


def test_coarse_join_matches():
    jb, jp, tb, tp, exp = _data("uniform", n=2048)
    kw = dict(num_parts=8, part_cap=512, buckets_per_part=32,
              max_out_per_part=1024)
    jpr = jc.radix_partition_scheduled(jb, schedule=(3,))
    jps = jc.radix_partition_scheduled(jp, schedule=(3,))
    tpr = tc.radix_partition_scheduled(tb, schedule=(3,))
    tps = tc.radix_partition_scheduled(tp, schedule=(3,))
    got = tc.phj_coarse_join(tpr, tps, **kw)
    assert_same(jc.phj_coarse_join(jpr, jps, **kw), got)
    assert np.array_equal(got.valid_pairs(), exp)


@pytest.mark.parametrize("n", [1 << 12, 1 << 22, 1 << 24])
def test_phj_knobs_match(n):
    for bits in (6, 13):
        assert tc.phj_bucket_count(n, bits) == jc.phj_bucket_count(n, bits)
        assert tc.default_shj_bits(n, bits) == jc.default_shj_bits(n, bits)
    assert tc.resolve_schedule(n) == jc.resolve_schedule(n)
    assert tc.resolve_schedule(n, bits_per_pass=4, num_passes=2) == (4, 4)
    assert (tc.phj.schedule_prefixes((4, 3, 3))
            == jc.phj.schedule_prefixes((4, 3, 3)))
    with pytest.raises(ValueError):
        tc.resolve_schedule(n, schedule=(4, 0))


SCHEMES = {"cpu_only": (1.0, 1.0), "gpu_only": (0.0, 0.0),
           "dd": (0.25, 0.4)}


@pytest.fixture(scope="module")
def coprocessors():
    return jc.CoProcessor(), tc.CoProcessor(c_device="cpu", g_device="cpu")


@pytest.mark.parametrize("kind", ["uniform", "high_skew"])
@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_coprocessor_phj_matches(coprocessors, scheme, kind):
    jcp, tcp_ = coprocessors
    pr, jr = SCHEMES[scheme]
    jb, jp, tb, tp, exp = _data(kind)
    mo = 2 * jb.size + len(exp)
    kw = dict(shj_bits=2, max_out=mo, partition_ratio=pr, join_ratio=jr)
    want, _ = jcp.phj(jb, jp, **kw)
    got, t = tcp_.phj(tb, tp, **kw)
    assert_same(want, got)
    assert np.array_equal(got.valid_pairs(), exp)
    assert set(t.phase_s) == {"partition", "join"}
    assert t.wall_s == t.phase_s["partition"] + t.phase_s["join"]
    assert t.notes["schedule"] == list(tc.resolve_schedule(tb.size))


class _Ctx:
    """A QueryContext stand-in: aborts at one named check."""

    def __init__(self, stop_at=None):
        self.stop_at = stop_at
        self.checks, self.partial = [], {}

    def check(self, where):
        self.checks.append(where)
        if where == self.stop_at:
            raise TimeoutError(where)

    def note_partial(self, tag, rel, passes):
        self.partial[tag] = (rel, passes)


def test_coprocessor_phj_preempt_and_resume(coprocessors):
    jcp, tcp_ = coprocessors
    jb, jp, tb, tp, exp = _data("uniform")
    kw = dict(schedule=(3, 3), shj_bits=2, max_out=3 * jb.size,
              partition_ratio=0.25, join_ratio=0.4)
    want, _ = jcp.phj(jb, jp, **kw)
    ctx = _Ctx(stop_at="partition:R:pass1")
    with pytest.raises(TimeoutError):
        tcp_.phj(tb, tp, ctx=ctx, **kw)
    rel, passes = ctx.partial["R"]
    assert passes == 1
    parts = {}
    got, t = tcp_.phj(tb, tp, ctx=_Ctx(), build_parts=rel, build_resume=1,
                      parts_out=parts, **kw)
    assert_same(want, got)
    assert t.notes["R_resumed_at"] == 1 and set(parts) == {"R", "S"}
    again, t2 = tcp_.phj(tb, tp, build_parts=parts["R"],
                         probe_parts=parts["S"], **kw)
    assert_same(want, again)
    assert t2.notes["build_parts_reused"] and t2.notes["probe_parts_reused"]


def test_coprocessor_fault_sites_and_discrete_bus(coprocessors, monkeypatch):
    _, _, tb, tp, exp = _data("uniform", n=1024)
    sites = []
    monkeypatch.setattr(tcp, "_FAULT_HOOK", sites.append)
    cp = tc.CoProcessor(c_device="cpu", g_device="cpu",
                        link=tc.PCIE_LINK, discrete=True)
    res, t = cp.phj(tb, tp, shj_bits=1, max_out=4096, partition_ratio=0.25,
                    join_ratio=0.4)
    assert np.array_equal(res.valid_pairs(), exp)
    assert {"h2d", "kernel", "d2h"} <= set(sites)
    assert t.transfer_bytes > 0 and t.transfer_s > 0


def test_coprocessor_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.CoProcessor()


def test_pass_planner_calibrates_on_a_port_group():
    from repro_torch.core.pass_planner import (PassPlanner,
                                               calibrate_partition_unit_costs)
    u = calibrate_partition_unit_costs(tcp.DeviceGroup("C", "cpu"), n=4096,
                                       reps=1)
    assert set(u) == {"n1", "n2", "n3"} and all(v > 0 for v in u.values())
    assert PassPlanner.from_measurements(u).plan(1 << 20).total_bits == 9
