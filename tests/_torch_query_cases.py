"""Shared cases for the query-pipeline parity tests: the same queries
built in both packages, and runs of a whole pipeline in each, reduced to
what must be equal."""
import dataclasses

import numpy as np
import pytest

import repro.core as jc
import repro.engine as je
import repro.queries as jq
import repro_torch.core as tc
import repro_torch.engine as te
import repro_torch.queries as tq

# No online feedback: measured times differ between the packages, and
# the plans must not.
NO_FEEDBACK = 1 << 40
PKGS = {"jax": (jq, je), "torch": (tq, te)}


@pytest.fixture(scope="module")
def cps():
    return {"jax": jc.CoProcessor(),
            "torch": tc.CoProcessor(c_device="cpu", g_device="cpu")}


def planner(me):
    return me.QueryPlanner(delta=0.25, min_feedback_items=NO_FEEDBACK)


def same_table(w, g):
    assert g.name == w.name
    assert [dataclasses.astuple(f) for f in g.filters] == \
        [dataclasses.astuple(f) for f in w.filters]
    assert list(g.columns) == list(w.columns)
    for c in w.columns:
        assert g.columns[c].dtype == w.columns[c].dtype == np.int32
        assert np.array_equal(g.columns[c], w.columns[c]), c


def same_query(w, g):
    assert list(g.tables) == list(w.tables)
    for name in w.tables:
        same_table(w.tables[name], g.tables[name])
    assert [dataclasses.astuple(j) for j in g.joins] == \
        [dataclasses.astuple(j) for j in w.joins]
    assert (g.aggregate, g.group_by, g.wrap32) == (w.aggregate, w.group_by,
                                                   w.wrap32)
    assert g.describe() == w.describe()


# ---------------------------------------------------------------------------
# Queries under test: each a function of the package's ``queries`` module.
# ---------------------------------------------------------------------------
def star(mq):
    return mq.make_star_query(2048, [256, 128, 64],
                              selectivities=[0.1, None, 0.5], seed=3,
                              aggregate=("sum", "F.m"))


def chain(mq):
    return mq.make_chain_query([1024, 512, 256], seed=5, aggregate=None)


def star_cycle(mq):
    """A star plus a cycle edge (a residual filter on a stage output) and
    a self edge (a residual filter on a base table)."""
    rng = np.random.default_rng(41)
    a = mq.Table("a", {"k1": rng.integers(0, 16, 512).astype(np.int32),
                       "k2": rng.integers(0, 4, 512).astype(np.int32),
                       "x": rng.integers(0, 3, 512).astype(np.int32),
                       "y": rng.integers(0, 3, 512).astype(np.int32)})
    b = mq.Table("b", {"id": np.arange(16, dtype=np.int32),
                       "id2": np.arange(16, dtype=np.int32) % 4})
    c = mq.Table("c", {"id": np.arange(3, dtype=np.int32)})
    return mq.Query(tables={"a": a, "b": b, "c": c},
                    joins=(mq.Join("a", "k1", "b", "id"),
                           mq.Join("a", "k2", "b", "id2"),
                           mq.Join("a", "x", "a", "y"),
                           mq.Join("a", "x", "c", "id")),
                    aggregate=("count",))


def star_empty(mq):
    """A dimension filtered to nothing: an empty intermediate."""
    q = mq.make_star_query(512, [64, 64], seed=7)
    q.tables["D0"] = q.tables["D0"].with_filters(mq.Filter("a", 5000, 5001))
    return q


def variants(mq):
    """Semi, anti and left-outer edges (left-outer pins textual order)."""
    return mq.make_star_query(2048, [256, 128, 200],
                              selectivities=[0.5, 0.3, 0.02], seed=9,
                              aggregate=("max", "F.m"),
                              join_kinds=("left_outer", "semi", "anti"))


def semi_anti(mq):
    return mq.make_star_query(2048, [256, 128], selectivities=[0.4, None],
                              seed=10, aggregate=("count",),
                              join_kinds=("semi", "anti"))


def grouped(mq):
    q = mq.make_star_query(1024, [128], selectivities=[0.5], seed=23,
                           aggregate=("sum", "F.m"), group_by=("F.g",))
    q.tables["F"].columns["m"][:] = 2**30        # wide sums past int32
    return q


def grouped_multi(mq):
    return mq.make_star_query(1024, [128, 64], seed=5, aggregate=("avg",
                                                                  "F.m"),
                              group_by=("D0.a", "F.g"))


def grouped_wrap(mq):
    q = grouped(mq)
    return mq.Query(tables=q.tables, joins=q.joins, aggregate=q.aggregate,
                    group_by=q.group_by, wrap32=True)


def grouped_outer(mq):
    return mq.make_star_query(1024, [128, 64], selectivities=[0.3, None],
                              seed=29, aggregate=("min", "F.m"),
                              join_kinds=("left_outer", "inner"),
                              group_by=("D0.a",))


def skewed_star(mq, seed: int = 7):
    """``tests/test_datapath_obs.py``'s estimator-hostile star (its first
    join's estimate is off by about 16x)."""
    rng = np.random.default_rng(seed)
    n = 8192
    fk0 = np.where(rng.random(n) < 0.5, rng.integers(0, 128, n),
                   rng.integers(100_000, 200_000, n)).astype(np.int32)
    fact = mq.Table("fact", {
        "fk0": fk0, "fk1": rng.integers(0, 144, n).astype(np.int32),
        "fk2": rng.integers(0, 4000, n).astype(np.int32),
        "v": rng.integers(0, 100, n).astype(np.int32)})
    d0 = mq.Table("d0", {"id": np.arange(128, dtype=np.int32),
                         "a": rng.integers(0, 10, 128).astype(np.int32)})
    d1 = mq.Table("d1", {"id": np.arange(144, dtype=np.int32),
                         "b": rng.integers(0, 10, 144).astype(np.int32)})
    d2 = mq.Table("d2", {"id": np.repeat(np.arange(40, dtype=np.int32), 10),
                         "c": rng.integers(0, 10, 400).astype(np.int32)})
    return mq.Query(tables={"fact": fact, "d0": d0, "d1": d1, "d2": d2},
                    joins=(mq.Join("fact", "fk0", "d0", "id"),
                           mq.Join("fact", "fk1", "d1", "id"),
                           mq.Join("fact", "fk2", "d2", "id")),
                    aggregate=("count",))


QUERIES = {f.__name__: f for f in (star, chain, star_cycle, star_empty,
                                   variants, semi_anti, grouped,
                                   grouped_multi, grouped_wrap,
                                   grouped_outer, skewed_star)}


# ---------------------------------------------------------------------------
# The executor: whole pipelines, both packages, against the oracle.
# ---------------------------------------------------------------------------
def run(key, cps, name, *, handoff, adaptive=False, order=None,
        repeats=1):
    mq, me = PKGS[key]
    svc = me.JoinQueryService(cp=cps[key], planner=planner(me),
                              num_workers=0)
    opt = mq.JoinOrderOptimizer(svc.planner, handoff=handoff)
    q = QUERIES[name](mq)
    physical = None if order is None else opt.price_order(
        q, opt.enumerate_orders(q)[order])
    ex = mq.PipelineExecutor(service=svc, optimizer=opt, handoff=handoff,
                             adaptive=adaptive)
    log = []
    for _ in range(repeats):
        res = ex.run(q, physical)
        rows = res.rows_array()
        log.append({
            "rows": rows, "n": res.rows, "aggregate": res.aggregate,
            "physical": res.physical.to_dict(),
            "plans": [dataclasses.asdict(o.plan) for o in res.outcomes],
            "hits": [(o.cache_hit, o.partition_cache_hit,
                      o.probe_partition_cache_hit) for o in res.outcomes],
            "moved": [o.host_bytes_moved for o in res.outcomes],
            "host_bytes_moved": res.host_bytes_moved,
            "replans": res.replans,
            "wall_ok": res.wall_s > 0})
    st = svc.stats()
    log.append({"ledger": svc.ledger.by_cause(),
                "cardinality": svc.cardinality.records(),
                "cache": st["cache"], "completed": st["completed"],
                "host_bytes_moved": st["host_bytes_moved"],
                "replans": st["metrics"].get("pipeline_replans", 0)})
    svc.close()
    return log, q


def check(cps, name, **kw):
    want, _ = run("jax", cps, name, **kw)
    got, q = run("torch", cps, name, **kw)
    ref_rows, ref_agg = tq.reference_execute(q)
    for w, g in zip(want[:-1], got[:-1]):
        assert np.array_equal(g["rows"], ref_rows)
        assert g["rows"].dtype == ref_rows.dtype
        assert g["aggregate"] == ref_agg
        assert np.array_equal(w.pop("rows"), g.pop("rows"))
    assert got == want
    return got


