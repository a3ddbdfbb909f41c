"""Port parity for the join-query engine: ``repro_torch.engine`` against
``repro.engine`` on the same NumPy data.  Fingerprints, cache sequences,
plans (every ``QueryPlan`` field, floats included: the same float64
arithmetic, so tolerance 0), workloads, admission decisions, the recovery
ladder and whole services are equal; every result is exact against its
NumPy oracle."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as jc
import repro.engine as je
import repro_torch.core as tc
import repro_torch.engine as te
import repro_torch.ops as tops

from _torch_parity import assert_same, relation

# No online feedback in the service tests: measured times differ between
# the packages, and the plans must not.
NO_FEEDBACK = 1 << 40


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def cps():
    return jc.CoProcessor(), tc.CoProcessor(c_device="cpu", g_device="cpu")


def _plan(p) -> dict:
    return dataclasses.asdict(p)


# ---------------------------------------------------------------------------
# Fingerprints and the build-table cache.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,nb", [(0, 0), (1, 1), (4096, 1024),
                                  (5000, 0)])
def test_fingerprint_digest_matches(n, nb):
    rng = np.random.default_rng(n)
    keys = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    rids = rng.permutation(n).astype(np.int32)
    jr, tr = relation(keys, rids)
    assert (te.relation_fingerprint(tr, nb)
            == je.relation_fingerprint(jr, nb))
    assert (te.partition_layout_key("fp", (7, 6), side="S")
            == je.partition_layout_key("fp", (7, 6), side="S"))


def _cache_script(m, core, tenant_budget):
    """Puts, gets and peeks of tables and layouts of several sizes under a
    budget that forces capacity and tenant evictions."""
    cache = m.BuildTableCache(budget_bytes=96 << 10,
                              tenant_budget_bytes=tenant_budget)
    log, keys = [], []
    for i, n in enumerate((256, 1024, 512, 2048, 768, 1536, 256)):
        rel = core.unique_relation(n, seed=i, **(
            {} if m is je else {"device": "cpu"}))
        nb = core.default_num_buckets(n)
        table = core.build_hash_table(rel, nb)
        key = m.relation_fingerprint(rel, nb)
        keys.append(key)
        tenant = ("a", "b")[i % 2]
        log.append(("nbytes", m.table_nbytes(table), m.table_nbytes(rel)))
        log.append(("get", key, cache.get(key, tenant) is not None))
        log.append(("put", cache.put(key, table, tenant)))
        pk = m.partition_layout_key(key, (3, 2))
        log.append(("pput", cache.put_partition(pk, rel, tenant)))
        if i >= 2:
            old = keys[i - 2]
            log.append(("peek", cache.peek(old) is not None,
                        cache.get(old, "a") is not None))
        log.append(("stats", cache.stats()))
    return log


@pytest.mark.parametrize("tenant_budget", [None, 40 << 10])
def test_cache_sequences_match(tenant_budget):
    want = _cache_script(je, jc, tenant_budget)
    got = _cache_script(te, tc, tenant_budget)
    assert got == want
    assert want[-1][1]["evictions"] > 0


# ---------------------------------------------------------------------------
# The planner.
# ---------------------------------------------------------------------------
SIZES = (256, 4096, 65536, 1 << 20, 1 << 24)


@pytest.mark.parametrize("kw", [
    {}, {"delta": 0.25}, {"allowed_schemes": je.SCHEMES},
    {"cache_bytes": 1 << 10, "rand_penalty": 8.0, "phj_overhead_s": 0.0}],
    ids=["default", "delta", "all_schemes", "phj_favoured"])
def test_planner_choices_match(kw):
    jp, tp = je.QueryPlanner(**kw), te.QueryPlanner(**kw)
    for b in SIZES:
        for p in (b // 2, 2 * b):
            for cached in (False, True):
                for kind in ("inner", "semi", "anti", "left_outer"):
                    for c_load, g_load in ((0.0, 0.0), (1.0, 0.01),
                                           (0.01, 1.0)):
                        args = dict(max_out=4 * p + 1024, cached=cached,
                                    kind=kind)
                        w = jp.choose(b, p, expect_reuse=not cached,
                                      c_load=c_load, g_load=g_load, **args)
                        g = tp.choose(b, p, expect_reuse=not cached,
                                      c_load=c_load, g_load=g_load, **args)
                        assert _plan(g) == _plan(w), (b, p, args)
                    assert (_plan(tp.choose_degraded(b, p, **args))
                            == _plan(jp.choose_degraded(b, p, **args)))
        for c_load, g_load in ((0.0, 0.0), (2.0, 0.0), (0.0, 2.0)):
            assert (_plan(tp.choose_groupby(b, c_load=c_load, g_load=g_load))
                    == _plan(jp.choose_groupby(b, c_load=c_load,
                                               g_load=g_load)))
    assert tp.stats() == jp.stats()
    assert tp.host_handoff_s(1 << 20) == jp.host_handoff_s(1 << 20)


def test_planner_observe_sequences_match():
    """The same (plan, measured Timing) feedback moves the online scales,
    the calibration version and then the plans identically."""
    jp, tp = je.QueryPlanner(), te.QueryPlanner()
    rng = np.random.default_rng(11)
    for i in range(60):
        b = int(SIZES[i % len(SIZES)])
        kind = ("inner", "semi")[i % 2]
        w = jp.choose(b, 2 * b, max_out=8 * b, kind=kind)
        g = tp.choose(b, 2 * b, max_out=8 * b, kind=kind)
        assert _plan(g) == _plan(w)
        phases = {k: float(rng.exponential(0.01)) for k in
                  ("build", "probe", "partition", "join", "agg")}
        jt, tt = jc.Timing(), tc.Timing()
        jt.phase_s.update(phases)
        tt.phase_s.update(phases)
        assert (te.QueryPlanner.phase_pairs(g, tt)
                == je.QueryPlanner.phase_pairs(w, jt))
        jp.observe(w, jt)
        tp.observe(g, tt)
        gb_w, gb_g = jp.choose_groupby(b), tp.choose_groupby(b)
        assert _plan(gb_g) == _plan(gb_w)
        jp.observe(gb_w, jt)
        tp.observe(gb_g, tt)
    assert tp.online.to_dict() == jp.online.to_dict()
    assert tp.online.version == jp.online.version > 0
    assert (tp.flag_replan(algorithm="shj") == jp.flag_replan(
        algorithm="shj"))
    assert tp.stats() == jp.stats()


# ---------------------------------------------------------------------------
# Workloads.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mix", list(je.MIXES))
def test_workload_matches(mix, seed):
    assert te.MIXES == je.MIXES
    want = je.make_workload(mix, 12, base_tuples=4096, seed=seed)
    got = te.make_workload(mix, 12, base_tuples=4096, seed=seed,
                           device="cpu")
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert (g.tag, g.max_out, g.query_id, g.kind) == (
            w.tag, w.max_out, w.query_id, w.kind)
        assert_same(w.build, g.build)
        assert_same(w.probe, g.probe)
        assert g.build.rid.device.type == "cpu"


def test_open_loop_matches():
    kw = dict(rate_qps=50.0, tenant_mix=(("gold", 2.0), ("bronze", 1.0)),
              arrivals="burst", hot_tenant="bronze", hot_skew=0.3,
              deadlines={"gold": 0.25}, base_tuples=1024, seed=3)
    want = je.open_loop(10, **kw)
    got = te.open_loop(10, device="cpu", **kw)
    for w, g in zip(want, got):
        assert (g.at_s, g.tenant, g.query.deadline_s, g.query.tag) == (
            w.at_s, w.tenant, w.query.deadline_s, w.query.tag)
        assert_same(w.query.probe, g.query.probe)


# ---------------------------------------------------------------------------
# The service, end to end (the slice as a whole).
# ---------------------------------------------------------------------------
def _service(m, cp, **kw):
    planner = kw.pop("planner", None) or m.QueryPlanner(
        min_feedback_items=NO_FEEDBACK)
    return m.JoinQueryService(cp=cp, planner=planner, num_workers=0, **kw)


def _counters(st: dict) -> dict:
    """The parts of ``stats()`` that hold no times."""
    return {k: st[k] for k in ("admitted", "rejected", "completed", "failed",
                               "shed", "degraded", "host_bytes_moved",
                               "queue_depth", "tenants", "cache", "planner",
                               "host_transfer_ledger", "resilience")} | {
        "flight": st["flight"]["counts"]}


def _same_outcome(w, g, oracle):
    assert _plan(g.plan) == _plan(w.plan)
    assert (g.cache_hit, g.partition_cache_hit,
            g.probe_partition_cache_hit, g.degraded, g.tag) == (
        w.cache_hit, w.partition_cache_hit, w.probe_partition_cache_hit,
        w.degraded, w.tag)
    assert_same(w.result, g.result)
    assert np.array_equal(g.result.valid_pairs(), oracle)


def test_service_mixed_workload_matches(cps):
    jcp, tcp_ = cps
    jsvc, tsvc = _service(je, jcp), _service(te, tcp_)
    jq = je.make_workload("mixed", 12, base_tuples=4096, seed=0)
    tq = te.make_workload("mixed", 12, base_tuples=4096, seed=0,
                          device="cpu")
    for w, g in zip(jq, tq):
        ow, og = jsvc.execute(w), tsvc.execute(g)
        _same_outcome(ow, og, tc.join_oracle(g.build, g.probe))
        assert og.wall_s >= sum(og.timing.phase_s.values())
    assert sum(r["cache_hit"] for r in tsvc.flight.dump()["records"]
               if r["kind"] == "outcome") > 0
    assert _counters(tsvc.stats()) == _counters(jsvc.stats())


def test_service_phj_partition_reuse_matches(cps):
    """PHJ plans through the service: the partition-layout cache hits on
    both sides, in both packages."""
    kw = dict(delta=0.25, cache_bytes=1 << 10, rand_penalty=8.0,
              phj_overhead_s=0.0, min_feedback_items=NO_FEEDBACK)
    jsvc = _service(je, cps[0], planner=je.QueryPlanner(**kw))
    tsvc = _service(te, cps[1], planner=te.QueryPlanner(**kw))
    jb, tb = relation(np.random.default_rng(3).integers(0, 4096, 4096))
    outs = []
    for i, seed in enumerate((4, 5, 4)):
        keys = np.random.default_rng(seed).integers(0, 4096, 4096)
        jp, tp = relation(keys)
        ow = jsvc.execute(je.JoinQuery(jb, jp, query_id=i,
                                       max_out=4 * 4096 + 1024))
        og = tsvc.execute(te.JoinQuery(tb, tp, query_id=i,
                                       max_out=4 * 4096 + 1024))
        _same_outcome(ow, og, tc.join_oracle(tb, tp))
        outs.append(og)
    assert [o.plan.algorithm for o in outs] == ["phj"] * 3
    assert [o.partition_cache_hit for o in outs] == [False, True, True]
    assert [o.probe_partition_cache_hit for o in outs] == [False, False,
                                                           True]
    assert _counters(tsvc.stats()) == _counters(jsvc.stats())


@pytest.mark.parametrize("kind", ["semi", "anti", "left_outer"])
def test_service_join_variants_match(cps, kind):
    jsvc, tsvc = _service(je, cps[0]), _service(te, cps[1])
    rng = np.random.default_rng(21)
    jb, tb = relation(rng.permutation(3000))
    jp, tp = relation(rng.integers(0, 6000, 4096))
    for qid in range(2):     # the second one probes the cached table
        ow = jsvc.execute(je.JoinQuery(jb, jp, query_id=qid, kind=kind))
        og = tsvc.execute(te.JoinQuery(tb, tp, query_id=qid, kind=kind))
        _same_outcome(ow, og, tops.join_variant_oracle(tb, tp, kind))
        assert og.cache_hit == (qid == 1)


@pytest.mark.parametrize("wrap32", [False, True])
def test_service_groupby_matches(cps, wrap32):
    jsvc, tsvc = _service(je, cps[0]), _service(te, cps[1])
    rng = np.random.default_rng(22)
    n = 8192
    keys = rng.integers(0, n // 64, n).astype(np.int32)
    vals = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    jk, tk = relation(keys)
    ow = jsvc.execute(je.GroupByQuery(jk, vals, query_id=1, wrap32=wrap32))
    og = tsvc.execute(te.GroupByQuery(tk, torch.from_numpy(vals),
                                      query_id=1, wrap32=wrap32))
    assert _plan(og.plan) == _plan(ow.plan)
    want = tops.groupby_ref(keys, vals, wrap32=wrap32)
    for got in (og.result.sorted(), ow.result.sorted()):
        for f in ("keys", "counts", "sums", "mins", "maxs"):
            assert np.array_equal(np.asarray(getattr(got, f)),
                                  getattr(want, f)), f


# ---------------------------------------------------------------------------
# Admission and resilience.
# ---------------------------------------------------------------------------
def _admission_script(m, core, cp):
    """Submissions with deadlines from hopeless to loose, under a fake
    clock: the admit/degrade/shed decisions, the Backpressure payloads,
    then the fair queue's dequeue order."""
    clk = FakeClock()
    svc = m.JoinQueryService(
        cp=cp, planner=m.QueryPlanner(delta=0.25), num_workers=0,
        clock=clk, tenants=[m.Tenant("gold", weight=2.0),
                            m.Tenant("bronze", deadline_s=1e-3)])
    svc._ensure_workers = lambda: None
    # The analytic planner prices the cheapest plan as the preferred one
    # at these sizes; a cheaper degraded price lets "degrade" happen.
    svc._degraded_estimate = lambda q: q.build.size * 1e-8
    dev = {} if m is je else {"device": "cpu"}
    log = []
    for i in range(12):
        n = (512, 2048, 8192)[i % 3]
        q = m.JoinQuery(core.unique_relation(n, seed=i, **dev),
                        core.uniform_relation(n, key_range=n, seed=50 + i,
                                              **dev),
                        query_id=i, tenant=("gold", "bronze")[i % 2],
                        deadline_s=(None, 1e-7, 3e-4, 1.0)[i % 4],
                        priority=i % 3)
        clk.t = 0.01 * i
        try:
            svc.submit(q, block=False)
            log.append(("admitted", i, q.degraded, q.deadline_at))
        except m.Backpressure as e:
            log.append(("refused", i, e.to_dict()))
    clk.t = 1.0
    while len(svc._queue):
        log.append(("dequeue", svc._queue.get_nowait()[0].query_id))
    return log, _counters(svc.stats())


def test_admission_decisions_match(cps):
    want = _admission_script(je, jc, cps[0])
    got = _admission_script(te, tc, cps[1])
    assert got == want
    actions = {e[0] for e in want[0]}
    assert {"admitted", "refused", "dequeue"} <= actions
    assert any(e[0] == "admitted" and e[2] for e in want[0])   # degraded


LADDER = ["retry", "retry", "degrade_fallback"]


@pytest.mark.parametrize("site,spec,events,reference", [
    ("kernel", dict(at=(1,)), LADDER[:1], False),
    ("h2d", dict(at=(1, 2)), LADDER[:2], False),
    ("kernel", dict(every=1), LADDER, True),
    ("h2d", dict(p=0.5), LADDER, True)])
def test_recovery_ladder_matches(cps, site, spec, events, reference):
    """One FaultSpec schedule, both packages: the same rung of the
    retry -> degrade -> breaker -> reference ladder, and an exact result.
    (A third failure opens the plan's breaker, so the degraded attempt
    short-circuits to the reference path.)"""
    rng = np.random.default_rng(31)
    bkeys, pkeys = rng.permutation(2048), rng.integers(0, 2048, 2048)
    out = {}
    for m, cp in ((je, cps[0]), (te, cps[1])):
        svc = _service(m, cp, retry=m.RetryPolicy(base_backoff_s=0.0))
        jb, tb = relation(bkeys)
        jp, tp = relation(pkeys)
        b, p = (jb, jp) if m is je else (tb, tp)
        q = m.JoinQuery(b, p, query_id=5, max_out=4 * 2048 + 1024)
        inj = m.FaultInjector(seed=7, sites={site: m.FaultSpec(**spec)})
        with m.injected(inj):
            o = svc._run_with_recovery(q)
        events = [e["what"] for e in svc.metrics.events("recovery")]
        out[m.__name__] = (events, o.degraded,
                           bool(o.timing.notes.get("reference_path")),
                           _counters(svc.stats())["resilience"],
                           inj.stats()["fired"])
        assert np.array_equal(o.result.valid_pairs(),
                              tc.join_oracle(tb, tp))
    assert out["repro_torch.engine"] == out["repro.engine"]
    assert out["repro.engine"][:3] == (events, reference, reference)
    assert te.faults.current() is None
    assert tc.coprocess._FAULT_HOOK is None


def test_corrupt_layout_is_a_cache_miss(cps):
    """A corrupt-mode cache insert is caught by the layout checksum at
    reuse, in both packages: a miss, never a wrong join."""
    kw = dict(delta=0.25, cache_bytes=1 << 10, rand_penalty=8.0,
              phj_overhead_s=0.0, min_feedback_items=NO_FEEDBACK)
    rng = np.random.default_rng(41)
    bkeys, pkeys = rng.permutation(2048), rng.integers(0, 2048, 2048)
    got = {}
    for m, cp in ((je, cps[0]), (te, cps[1])):
        svc = _service(m, cp, planner=m.QueryPlanner(**kw))
        jb, tb = relation(bkeys)
        jp, tp = relation(pkeys)
        b, p = (jb, jp) if m is je else (tb, tp)
        with m.injected(m.FaultInjector(seed=1, sites={
                "cache_insert": m.FaultSpec(mode="corrupt", every=1)})):
            outs = [svc.execute(m.JoinQuery(b, p, query_id=i,
                                            max_out=4 * 2048 + 1024))
                    for i in range(2)]
        for o in outs:
            assert np.array_equal(o.result.valid_pairs(),
                                  tc.join_oracle(tb, tp))
        got[m.__name__] = ([o.partition_cache_hit for o in outs],
                           _counters(svc.stats())["resilience"])
    assert got["repro_torch.engine"] == got["repro.engine"]
    assert got["repro.engine"][1]["cache_validation_failures"] >= 2


class StepClock:
    """Advances by ``dt`` on every read, so the pass-boundary deadline
    checks land on the same pass in both packages."""

    def __init__(self, dt):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t


def _force_phj(m, schedule):
    """A planner pinned to one PHJ schedule (the checkpoint path needs a
    multi-pass partition phase, not a cost-model arbitration)."""
    core = jc if m is je else tc

    class ForcePhj(m.QueryPlanner):
        def choose(self, build_n, probe_n, *, max_out, **kw):
            plan = self._phj_candidate(build_n, probe_n)
            return dataclasses.replace(
                plan, schedule=schedule, max_out=int(max_out),
                shj_bits=core.default_shj_bits(build_n, sum(schedule)))

    return ForcePhj(delta=0.25, min_feedback_items=NO_FEEDBACK)


def test_deadline_preemption_checkpoint_and_resume_match(cps):
    """A deadline blown at a pass boundary checkpoints the completed pass;
    the re-admitted query resumes from it.  Same decisions, counters and
    exact result in both packages."""
    rng = np.random.default_rng(23)
    bkeys, pkeys = rng.permutation(2048), rng.integers(0, 2048, 2048)
    got = {}
    for m, cp in ((je, cps[0]), (te, cps[1])):
        svc = m.JoinQueryService(cp=cp, planner=_force_phj(m, (4, 4)),
                                 num_workers=0, preempt=True,
                                 clock=StepClock(0.2))
        jb, tb = relation(bkeys)
        jp, tp = relation(pkeys)
        b, p = (jb, jp) if m is je else (tb, tp)
        with pytest.raises(m.DeadlineExceeded):
            svc.execute(m.JoinQuery(b, p, query_id=1, deadline_s=0.5,
                                    max_out=4 * 2048 + 1024))
        out = svc.execute(m.JoinQuery(b, p, query_id=2,
                                      max_out=4 * 2048 + 1024))
        assert np.array_equal(out.result.valid_pairs(),
                              tc.join_oracle(tb, tp))
        got[m.__name__] = [out.timing.notes.get("R_resumed_at"),
                           _counters(svc.stats())["resilience"],
                           out.result]
    assert_same(got["repro.engine"].pop(), got["repro_torch.engine"].pop())
    assert got["repro_torch.engine"] == got["repro.engine"]
    assert got["repro.engine"][0] == 1
    assert got["repro.engine"][1]["checkpoints"] == 1
    assert got["repro.engine"][1]["partition_resumes"] == 1


def test_calibrated_planner_measures_both_groups(cps):
    """``QueryPlanner.calibrated`` on CPU groups: every step of both series
    gets a measured (C, G) unit cost, the partition passes are measured
    on both groups, and the hand-off is priced; the planner then plans."""
    pl = te.QueryPlanner.calibrated(cps[1], n=4096, reps=1)
    assert set(pl.u_overrides) == {"b1", "b2", "b3", "b4",
                                   "p1", "p2", "p3", "p4"}
    assert all(c > 0 and g > 0 for c, g in pl.u_overrides.values())
    pp = pl.pass_planner
    assert min(pp.u_n1, pp.u_n2, pp.u_n3, *pp.u_g.values()) > 0
    assert pl.partition_device_g is None
    assert pl.handoff_latency_s > 0 and pl.handoff_bw_bytes_per_s >= 1e8
    for n in (4096, 1 << 20):
        assert pl.choose(n, n, max_out=4 * n).algorithm in ("shj", "phj")


def test_pass_model_prices_g_at_measured_costs():
    """A measured ``u_g`` prices the G share of a pass; without it G
    mirrors C, as in the reference."""
    from repro_torch.core import PassPlanner
    c = {"n1": 4e-8, "n2": 2e-9, "n3": 8e-9}
    g = {"n1": 4e-11, "n2": 2e-11, "n3": 8e-11}
    mirror = PassPlanner.from_measurements(c)
    split = PassPlanner.from_measurements(c, u_g=g)
    n, bits = 1 << 20, 10
    on_g = np.zeros((1, 3))                 # every step on the G group
    assert (mirror.pass_model(n, bits).estimate_batch(on_g)[0]
            == mirror.pass_model(n, bits).estimate_batch(on_g + 1)[0])
    assert (split.pass_model(n, bits).estimate_batch(on_g)[0]
            < 1e-2 * split.pass_model(n, bits).estimate_batch(on_g + 1)[0])
    assert split.plan(n) == mirror.plan(n)  # schedules priced on C


def test_entry_points_default_to_the_card():
    """``JoinQueryService()`` builds a ``CoProcessor`` with its G group on
    ``cuda:0`` and the generators make relations on the card; without
    one they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.JoinQueryService()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.make_workload("mixed", 2, base_tuples=1024)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.open_loop(2, base_tuples=1024)
