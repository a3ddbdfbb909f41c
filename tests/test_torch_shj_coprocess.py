"""Port parity for the co-processed SHJ: ``CoProcessor.shj`` under every
scheme and table mode, ``build_table``'s shared-mode table and
``basic_unit_shj`` (repro_torch) against ``repro.core.CoProcessor`` on the
same data: whole padded ``JoinResult`` and ``transfer_bytes`` bit for
bit."""
import numpy as np
import pytest

import repro.core as jc
import repro_torch.core as tc
from repro_torch.core import coprocess as tcp, interop

from _torch_parity import assert_same, to_torch

# tests/test_coprocess.py's schemes, plus OL (build on C, probe on G).
SCHEMES = {
    "cpu_only": ([1.0] * 4, [1.0] * 4),
    "gpu_only": ([0.0] * 4, [0.0] * 4),
    "ol": ([1.0, 1.0, 0.0, 0.0], [0.0, 0.0, 1.0, 1.0]),
    "dd": ([0.25] * 4, [0.5] * 4),
    "pl": ([0.0, 0.25, 0.5, 0.25], [0.0, 0.25, 0.75, 0.25]),
}


@pytest.fixture(scope="module")
def data():
    jb = jc.unique_relation(2048, seed=1)
    jp = jc.uniform_relation(4096, key_range=3000, seed=2)
    return jb, jp, to_torch(jb), to_torch(jp), jc.join_oracle(jb, jp)


@pytest.fixture(scope="module")
def coprocessors():
    return jc.CoProcessor(), tc.CoProcessor(c_device="cpu", g_device="cpu")


@pytest.mark.parametrize("mode", ["shared", "separate"])
@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_shj_schemes_match(data, coprocessors, scheme, mode):
    jb, jp, tb, tp, exp = data
    jcp, tcp_ = coprocessors
    br, pr = SCHEMES[scheme]
    kw = dict(num_buckets=512, max_out=32768, build_ratios=br,
              probe_ratios=pr, table_mode=mode)
    want, wt = jcp.shj(jb, jp, **kw)
    got, t = tcp_.shj(tb, tp, **kw)
    assert_same(want, got)
    assert np.array_equal(got.valid_pairs(), exp)
    assert t.transfer_bytes == wt.transfer_bytes
    assert set(t.phase_s) == {"build", "probe"}
    assert t.wall_s == t.phase_s["build"] + t.phase_s["probe"] > 0
    assert (t.merge_s > 0) == (mode == "separate" and scheme == "dd")


@pytest.mark.parametrize("scheme", ["gpu_only", "dd", "pl"])
def test_shj_truncates_like_reference(data, coprocessors, scheme):
    """max_out below the match count: the per-group slack, the prefix cut
    and the C-then-G concatenation all show in the padded result."""
    jb, jp, tb, tp, exp = data
    jcp, tcp_ = coprocessors
    br, pr = SCHEMES[scheme]
    kw = dict(num_buckets=256, max_out=len(exp) // 3, build_ratios=br,
              probe_ratios=pr)
    want, _ = jcp.shj(jb, jp, **kw)
    got, _ = tcp_.shj(tb, tp, **kw)
    assert_same(want, got)
    assert int(got.count) == len(exp) // 3


def test_shj_discrete_emulation_matches(data):
    jb, jp, tb, tp, exp = data
    kw = dict(num_buckets=512, max_out=32768, build_ratios=[0.25] * 4,
              probe_ratios=[0.5] * 4, table_mode="separate")
    want, wt = jc.CoProcessor(link=jc.PCIE_LINK, discrete=True).shj(
        jb, jp, **kw)
    got, t = tc.CoProcessor("cpu", "cpu", link=tc.PCIE_LINK,
                            discrete=True).shj(tb, tp, **kw)
    assert_same(want, got)
    assert np.array_equal(got.valid_pairs(), exp)
    assert t.transfer_bytes == wt.transfer_bytes > 0
    assert t.transfer_s == pytest.approx(wt.transfer_s, rel=1e-12)


@pytest.mark.parametrize("ratio,mode", [(0.25, "shared"), (0.6, "shared"),
                                        (0.25, "separate")])
def test_build_table_matches_field_by_field(data, coprocessors, ratio,
                                            mode):
    """Shared mode with 0 < cut < n stitches two bucket ranges
    (``_concat_bucket_ranges``); separate mode merges on C."""
    jb, _, tb, _, _ = data
    jcp, tcp_ = coprocessors
    assert 0 < tcp_._cut(tb.size, ratio) < tb.size
    kw = dict(num_buckets=512, ratios=[ratio] * 4, table_mode=mode)
    want, wt = jcp.build_table(jb, **kw)
    got, t = tcp_.build_table(tb, **kw)
    assert_same(want, got)
    assert t.transfer_bytes == wt.transfer_bytes
    assert got.nbytes == sum(np.asarray(x).nbytes for x in
                             (want.bucket_key_start, want.bucket_key_count,
                              want.ukeys, want.key_rid_start,
                              want.key_rid_count, want.rids, want.skeys,
                              want.num_keys))


def test_probe_table_reuses_a_built_table(data, coprocessors):
    jb, jp, tb, tp, exp = data
    jcp, tcp_ = coprocessors
    table, _ = tcp_.build_table(tb, num_buckets=512, ratios=[0.0] * 4)
    for ratios in ([0.0] * 4, [0.5] * 4, [1.0] * 4):
        jt, _ = jcp.build_table(jb, num_buckets=512, ratios=[0.0] * 4)
        want, _ = jcp.probe_table(jp, jt, max_out=32768, ratios=ratios)
        got, t = tcp_.probe_table(tp, table, max_out=32768, ratios=ratios)
        assert_same(want, got)
        assert set(t.phase_s) == {"probe"} and t.wall_s == t.phase_s["probe"]


def test_basic_unit_shj_matches(data, coprocessors):
    jb, jp, tb, tp, exp = data
    jcp, tcp_ = coprocessors
    kw = dict(num_buckets=512, max_out=32768, chunk=512)
    want, _, _ = jcp.basic_unit_shj(jb, jp, **kw)
    got, t, ratios = tcp_.basic_unit_shj(tb, tp, **kw)
    assert_same(want, got)
    assert np.array_equal(got.valid_pairs(), exp)
    assert set(ratios) == {"build", "probe"}
    assert all(0.0 <= r <= 1.0 for r in ratios.values())
    assert t.wall_s == pytest.approx(t.phase_s["build"] + t.phase_s["probe"])


def test_basic_unit_result_does_not_depend_on_schedule(data, monkeypatch):
    """Whatever group the timing favours, the result is the same."""
    _, _, tb, tp, exp = data
    cp = tc.CoProcessor("cpu", "cpu")
    kw = dict(num_buckets=512, max_out=32768, chunk=512)
    results = []
    for fake in ([1.0, 0.001] * 2, [0.001, 1.0] * 2):
        times = iter(fake)
        monkeypatch.setattr(tcp, "_time_once",
                            lambda grp, fn, *a: next(times))
        res, _, ratios = cp.basic_unit_shj(tb, tp, **kw)
        results.append((res, ratios))
    (a, ra), (b, rb) = results
    assert ra["build"] < 0.5 < rb["build"]
    for x, y in zip(interop.to_numpy(a), interop.to_numpy(b)):
        assert np.array_equal(x, y)


def test_shj_fault_sites_and_group_locks(data, monkeypatch):
    _, _, tb, tp, exp = data
    sites = []
    monkeypatch.setattr(tcp, "_FAULT_HOOK", sites.append)
    cp = tc.CoProcessor("cpu", "cpu")
    res, _ = cp.shj(tb, tp, num_buckets=512, max_out=32768,
                    build_ratios=[0.25] * 4, probe_ratios=[0.5] * 4)
    assert np.array_equal(res.valid_pairs(), exp)
    assert {"h2d", "kernel"} <= set(sites)
    assert set(cp.group_locks) == {"C", "G"}
    with cp.group_locks["C"], cp.group_locks["G"]:
        pass
    with pytest.raises(ValueError):
        cp.build_table(tb, num_buckets=512, ratios=[0.0] * 4,
                       table_mode="split")
