"""Probe-heavy foreign-key joins through ``JoinQueryService`` on the CPU,
the benchmark's ``phj_balkesen_a`` deployment at test size: a unique-key
relation P built and a relation F of 16 |P| tuples whose keys are drawn
uniformly over P's, probed.  Each answer equals bench's plain reference
pair for pair, under the planner's own choice, under PHJ at fixed pass
schedules and under SHJ; traced, each side's partition passes open one
``partition.build`` / ``partition.probe`` span, and a reused layout none.
"""
import gc
import weakref

import pytest

from bench.data.relations import make_relation
from bench.reference.join import join_pairs, pair_codes, wrong_pairs
from repro_torch.core.coprocess import CoProcessor
from repro_torch.core.pass_planner import PassPlan, PassPlanner, \
    default_planner
from repro_torch.core.relation import Relation
from repro_torch.engine import JoinQuery, JoinQueryService, QueryPlanner
from repro_torch.obs import Tracer

SEED = 2**32 + 35
SPANS = ("partition.build", "partition.probe")


class FixedPasses(PassPlanner):
    """The default pass planner's costs with a fixed schedule."""

    def __init__(self, schedule):
        base = default_planner()
        super().__init__(base.u_n1, base.u_n2, base.u_n3)
        self.schedule = tuple(schedule)

    def plan(self, n, total_bits=None):
        return PassPlan(self.schedule, self.schedule_cost(n, self.schedule))


def _pair(n: int, stream: int):
    """P of ``n`` unique keys and F of ``16 n`` keys uniform over them."""
    specs = {"P": {"rows": n, "keys": {"dist": "unique"}},
             "F": {"rows": 16 * n, "keys": {"dist": "uniform", "range": n}}}
    return tuple(make_relation(spec, "cpu", SEED, "query", stream, role)
                 for role, spec in specs.items())


def _service(planner: QueryPlanner) -> JoinQueryService:
    return JoinQueryService(cp=CoProcessor(c_device="cpu", g_device="cpu"),
                            planner=planner)


def _answer(svc, p, f):
    out = svc.submit(JoinQuery(Relation(*p), Relation(*f)))()
    c = int(out.result.count)
    return out, pair_codes(out.result.probe_rid[:c], out.result.build_rid[:c])


SCHEDULES = {"phj_one_pass": (4,), "phj_two_passes": (3, 3)}


def _planner(how: str) -> QueryPlanner:
    """The planner's own choice, PHJ at a fixed schedule, or SHJ alone."""
    if how in SCHEDULES:
        return QueryPlanner(phj_overhead_s=-1.0,
                            pass_planner=FixedPasses(SCHEDULES[how]))
    return QueryPlanner(allow_phj=how != "shj")


@pytest.mark.parametrize("n", [1 << 10, 1 << 12])
@pytest.mark.parametrize("how", ["planner", *SCHEDULES, "shj"])
def test_foreign_key_join_matches_the_reference(how, n):
    p, f = _pair(n, 0)
    want = join_pairs(*p, *f)
    assert want.shape[0] == 16 * n            # each F tuple meets one P
    svc = _service(_planner(how))
    try:
        for _ in range(2):                    # cold, then layouts cached
            out, got = _answer(svc, p, f)
            if how in SCHEDULES:
                assert out.plan.algorithm == "phj"
                assert tuple(out.plan.schedule) == SCHEDULES[how]
            elif how == "shj":
                assert out.plan.algorithm == "shj"
            assert wrong_pairs(got, want) == 0
    finally:
        svc.close()


def _spans(out) -> dict:
    return {name: [s["attrs"] for s in out.trace if s["name"] == name]
            for name in SPANS}


@pytest.mark.parametrize("schedule", [(4,), (3, 3)])
def test_partition_spans_per_side_and_none_for_a_reused_layout(schedule):
    """A cold query spans both sides (``rows`` |P| and |F|, ``card_rows``
    the G slice's, ``passes`` the schedule's); the same pair again
    reuses both layouts and spans neither; the same P with a new F
    spans F alone."""
    n = 1 << 10
    p, f = _pair(n, 0)
    _, f2 = _pair(n, 1)
    svc = _service(QueryPlanner(phj_overhead_s=-1.0,
                                pass_planner=FixedPasses(schedule)))
    try:
        out, got = _answer(svc, p, f)
        assert out.plan.algorithm == "phj"
        assert wrong_pairs(got, join_pairs(*p, *f)) == 0
        spans = _spans(out)
        for name, rows in zip(SPANS, (n, 16 * n)):
            (attrs,) = spans[name]
            cut = svc.cp._cut(rows, out.plan.partition_ratio)
            assert attrs["rows"] == rows
            assert attrs["card_rows"] == rows - cut
            assert attrs["passes"] == len(schedule)
            assert attrs["q_key"] == out.trace[0]["attrs"]["q_key"]

        out, got = _answer(svc, p, f)
        assert out.partition_cache_hit and out.probe_partition_cache_hit
        assert _spans(out) == {name: [] for name in SPANS}
        assert wrong_pairs(got, join_pairs(*p, *f)) == 0

        out, got = _answer(svc, p, f2)
        assert out.partition_cache_hit
        assert not out.probe_partition_cache_hit
        spans = _spans(out)
        assert spans["partition.build"] == []
        assert [a["rows"] for a in spans["partition.probe"]] == [16 * n]
        assert wrong_pairs(got, join_pairs(*p, *f2)) == 0
    finally:
        svc.close()


def test_a_disabled_tracer_records_no_partition_span():
    """A ``CoProcessor`` whose tracer is off answers alike and records
    nothing; the same join on an enabled tracer spans both sides."""
    n = 1 << 10
    p, f = _pair(n, 0)
    want = join_pairs(*p, *f)
    for enabled in (False, True):
        tracer = Tracer(enabled=enabled)
        cp = CoProcessor(c_device="cpu", g_device="cpu", tracer=tracer)
        res, timing = cp.phj(Relation(*p), Relation(*f), schedule=(4,),
                             shj_bits=2, max_out=16 * n + 1024,
                             partition_ratio=0.5, join_ratio=0.5)
        c = int(res.count)
        got = pair_codes(res.probe_rid[:c], res.build_rid[:c])
        assert wrong_pairs(got, want) == 0
        assert set(timing.phase_s) == {"partition", "join"}
        names = [s.name for s in tracer.spans()]
        assert [x for x in names if x in SPANS] == (
            list(SPANS) if enabled else [])


def test_the_fingerprint_memo_keeps_no_relation_alive():
    """The same relation objects again hit the fingerprint memo; once the
    client drops them, nothing of the service (its memo, its workers)
    keeps their columns alive (at 2^28 tuples each F holds 2 GiB of the
    card), and new relations miss the memo."""
    p, f = _pair(1 << 10, 0)
    rels = Relation(*p), Relation(*f)
    svc = _service(QueryPlanner())
    try:
        svc.submit(JoinQuery(*rels))()
        out = svc.submit(JoinQuery(*rels))()
        memo = {s["attrs"]["memo"] for s in out.trace
                if s["name"] == "fingerprint"}
        assert memo == {"hit"}
        refs = [weakref.ref(t) for t in (*p, *f)]
        del p, f, rels, out
        gc.collect()
        assert [r() for r in refs] == [None] * 4
        q, g = _pair(1 << 10, 1)
        out = svc.submit(JoinQuery(Relation(*q), Relation(*g)))()
        memo = [s["attrs"]["memo"] for s in out.trace
                if s["name"] == "fingerprint"]
        assert memo[0] == "miss"      # a reused id is not the dead array
        c = int(out.result.count)
        got = pair_codes(out.result.probe_rid[:c], out.result.build_rid[:c])
        assert wrong_pairs(got, join_pairs(*q, *g)) == 0
    finally:
        svc.close()


def test_a_memo_entry_left_by_a_dead_array_is_not_hit():
    """A new relation whose columns reuse the ids of dead ones (planted
    here: their entries point at the first pair's keys, whose layouts
    are cached) is hashed anew and answered from its own content."""
    n = 1 << 10
    p, f = _pair(n, 0)
    q, g = _pair(n, 1)
    svc = _service(QueryPlanner(phj_overhead_s=-1.0,
                                pass_planner=FixedPasses((4,))))
    try:
        svc.submit(JoinQuery(Relation(*p), Relation(*f)))()
        dead = weakref.ref(p[0].clone())
        assert dead() is None
        for new, old in ((q, p), (g, f)):
            for (rid_id, key_id, nb), entry in list(svc._fp_cache.items()):
                if (rid_id, key_id) == (id(old[0]), id(old[1])):
                    svc._fp_cache[id(new[0]), id(new[1]), nb] = (
                        entry[0], dead, dead)
        out, got = _answer(svc, q, g)
        assert not out.partition_cache_hit
        assert not out.probe_partition_cache_hit
        assert wrong_pairs(got, join_pairs(*q, *g)) == 0
    finally:
        svc.close()
