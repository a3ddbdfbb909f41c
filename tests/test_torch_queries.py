"""Port parity for the multi-join query pipeline: ``repro_torch.queries``
against ``repro.queries`` on the same NumPy tables.  Generated tables are
equal bit for bit; plans are equal to the last float bit (the same
float64 pricing, tolerance 0); pipeline runs give equal rows,
aggregates, stage plans, cache-hit sequences, hand-off bytes, ledger
totals and cardinality records; and every result equals
``reference_execute``.

Both services run with ``num_workers=0`` and a planner that takes no
online feedback, so plans depend on the data alone."""
import dataclasses

import numpy as np
import pytest

import repro.queries as jq
import repro_torch.engine as te
import repro_torch.queries as tq

from _torch_query_cases import (PKGS, QUERIES, check, cps,  # noqa: F401
                                planner, same_query)


@pytest.mark.parametrize("name", list(QUERIES))
def test_queries_are_equal(name):
    same_query(QUERIES[name](jq), QUERIES[name](tq))


@pytest.mark.parametrize("seed", [0, 1, 17])
def test_generators_match(seed):
    for args in (dict(fact_rows=4096, dim_rows=[512, 256, 64],
                      selectivities=[0.02, None, 0.5]),
                 dict(fact_rows=300, dim_rows=[7], join_kinds=["semi"],
                      group_by=("F.g",))):
        same_query(jq.make_star_query(seed=seed, **args),
                   tq.make_star_query(seed=seed, **args))
    same_query(jq.make_chain_query([1024, 300, 64, 9], seed=seed),
               tq.make_chain_query([1024, 300, 64, 9], seed=seed))


def test_reference_helpers_match():
    for name in ("star", "variants", "grouped_multi", "grouped_outer"):
        w, g = reference_both(name)
        assert np.array_equal(g[0], w[0]) and g[1] == w[1]
    cols = tq.reference_rows(QUERIES["grouped"](tq))
    for agg in (("count",), ("sum", "F.m"), ("min", "F.m"), ("max", "F.m"),
                ("avg", "F.m"), None):
        assert tq.apply_aggregate(cols, agg) == jq.apply_aggregate(cols,
                                                                   agg)
        for wrap in (False, True):
            got = tq.apply_group_by(cols, ("F.g",), agg, wrap32=wrap)
            want = jq.apply_group_by(cols, ("F.g",), agg, wrap32=wrap)
            assert list(got) == list(want)
            assert all(np.array_equal(got[k], want[k]) for k in want)
    assert tq.NULL_VALUE == jq.NULL_VALUE and tq.JOIN_KINDS == jq.JOIN_KINDS


def reference_both(name):
    return (jq.reference_execute(QUERIES[name](jq)),
            tq.reference_execute(QUERIES[name](tq)))


# ---------------------------------------------------------------------------
# The optimizer: plans equal to the last bit.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("handoff", ["device", "host"])
@pytest.mark.parametrize("name", list(QUERIES))
def test_optimizer_plans_match(name, handoff):
    got, want = {}, {}
    for key, out in (("jax", want), ("torch", got)):
        mq, me = PKGS[key]
        pl = planner(me)
        opt = mq.JoinOrderOptimizer(pl, handoff=handoff)
        q = QUERIES[name](mq)
        out["optimize"] = opt.optimize(q).to_dict()
        out["worst"] = opt.worst_order(q).to_dict()
        out["orders"] = [[str(j) for j in o]
                         for o in opt.enumerate_orders(q)]
        out["priced"] = [opt.price_order(q, o).to_dict()
                         for o in opt.enumerate_orders(q)]
        out["stage_plans"] = [dataclasses.asdict(s.plan)
                              for s in opt.optimize(q).stages]
        greedy = mq.JoinOrderOptimizer(pl, exhaustive_joins=1,
                                       handoff=handoff)
        out["greedy"] = greedy.optimize(q).to_dict()
        # Re-pricing the tail from an observed first stage (the adaptive
        # path), at the true and at a far-off cardinality.
        if len(q.joins) >= 3:
            j0 = q.joins[0]
            out["reprice"] = [
                None if p is None else p.to_dict() for p in (
                    opt.reprice_remaining(q, [j0], list(q.joins[1:]),
                                          {id(j0): rows})
                    for rows in (1, 4096, 1 << 20))]
        out["planner"] = pl.stats()
    assert got == want


def ssb_queries(mq, cell, tables):
    """A cell's queries in package ``mq`` over shared ``Table`` objects,
    one per table and set of filters, as the benchmark's drivers build
    them.  The reference sums one column, and a plan does not read the
    sink's operand, so its side sums an expression's first column."""
    from bench.drivers.ssb_flights import referenced
    from bench import harness
    specs = harness.cell_spec(cell)[3]["queries"]
    cols: dict = {}
    for spec in specs.values():
        for t, cs in referenced(spec).items():
            cols.setdefault(t, [])
            cols[t] += [c for c in cs if c not in cols[t]]
    shared: dict = {}

    def table(name, filters):
        key = (name, tuple(map(tuple, filters)))
        if key not in shared:
            shared[key] = mq.Table(
                name, {c: tables[name][c] for c in cols[name]},
                [mq.Filter(c, lo, hi) for c, lo, hi in filters])
        return shared[key]

    def aggregate(kind, operand):
        if isinstance(operand, str):
            return kind, operand
        return (kind, tuple(operand)) if mq is tq else (kind, operand[1])

    return {name: mq.Query(
                tables={t: table(t, fs) for t, fs in spec["tables"].items()},
                joins=tuple(mq.Join(*j) for j in spec["joins"]),
                aggregate=aggregate(*spec["aggregate"]),
                group_by=tuple(spec["group_by"]))
            for name, spec in specs.items()}


@pytest.mark.parametrize("cell", ["ssb_sf2.flights14", "ssb_sf2.flights23"])
def test_ssb_plans_match_and_scan_each_range_once(cell):
    """The benchmark's SSB queries at 4000 lineorder rows, each planned
    twice on shared tables: the reference's plans on both calls, one scan
    of each filtered column per table on the first and none on the
    second."""
    from bench.data.ssb_flights import make_tables
    from bench import harness
    data = harness.cell_spec(cell)[2]["data"]
    data["rows"] = {"lineorder": 4000, "customer": 300, "supplier": 40,
                    "part": 2000, "date": 2556}
    tables = make_tables(data, 2**31 + 7)
    want_q = ssb_queries(jq, cell, tables)
    got_q = ssb_queries(tq, cell, tables)
    want_opt, got_opt = (mq.JoinOrderOptimizer(planner(me), handoff="device")
                         for mq, me in (PKGS["jax"], PKGS["torch"]))
    for name, q in got_q.items():
        for call in (1, 2):
            before = {t: t.stats() for t in q.tables.values()}
            got = got_opt.optimize(q).to_dict()
            assert got == want_opt.optimize(want_q[name]).to_dict(), \
                (name, call)
            for t in q.tables.values():
                ranged = {f.column for f in t.filters}
                scans = t.stats()["range_scans"]
                if call == 1:
                    # Every filtered column, once, on its first query.
                    assert scans == len(ranged), (name, t.name)
                else:
                    assert scans == before[t]["range_scans"], (name, t.name)
                    assert (t.stats()["range_hits"]
                            > before[t]["range_hits"]) == bool(ranged)


INT32 = np.iinfo(np.int32)


@pytest.mark.parametrize("case", [
    ("empty", [], [(0, 5, None), (-3, 3, None)]),
    ("annotated", [1, 5, 9], [(0, 2, 0.3), (0, 2, 1.7), (0, 2, -0.2),
                              (4, 6, None)]),
    ("outside", list(range(10, 21)), [(100, 200, None), (-50, -10, None),
                                       (-1000, 1000, None), (20, 21, None)]),
    ("one_value", [7, 7, 7], [(7, 8, None), (0, 7, None), (8, 9, None)]),
    ("overlapping", [3, 40, 17, 8, 25], [(5, 30, None), (3, 15, None),
                                          (10, 12, None)]),
    ("int32_extremes", [INT32.min, 0, INT32.max],
     [(INT32.min, 0, None), (1, INT32.max, None), (-5, 5, 0.5)]),
], ids=lambda case: case[0])
def test_range_estimates_match_the_reference(case):
    """``Filter.estimate`` and ``Table.est_rows`` / ``ndv_est`` are the
    reference's floats exactly, from the range memo; a ``with_filters``
    table starts with an empty memo."""
    _, values, ranges = case
    col = np.asarray(values, dtype=np.int32)
    other = np.arange(col.size, dtype=np.int32)
    tables = {}
    for mq in (jq, tq):
        filters = [mq.Filter("a", lo, hi, sel) for lo, hi, sel in ranges]
        base = mq.Table("t", {"a": col, "b": other})
        tables[mq] = (base, base.with_filters(*filters),
                      [f.estimate(col) for f in filters])
    (_, want, want_est), (base, got, got_est) = tables[jq], tables[tq]
    assert got_est == want_est
    assert got.stats() == {"range_scans": 0, "range_hits": 0}
    for _ in range(2):
        assert got.est_rows() == want.est_rows()
        assert [got.ndv_est(c) for c in "ab"] == \
            [want.ndv_est(c) for c in "ab"]
    ranged = {f.column for f in got.filters if f.selectivity is None}
    assert got.stats()["range_scans"] == len(ranged)
    assert base.stats() == {"range_scans": 0, "range_hits": 0}
    again = got.with_filters(tq.Filter("b", 0, 1))
    assert again.stats() == {"range_scans": 0, "range_hits": 0}
    assert again.est_rows() == want.with_filters(
        jq.Filter("b", 0, 1)).est_rows()


@pytest.mark.parametrize("handoff", ["device", "host"])
@pytest.mark.parametrize("name", ["star", "chain", "star_cycle",
                                  "star_empty", "variants", "grouped",
                                  "grouped_multi", "grouped_wrap",
                                  "grouped_outer"])
def test_pipeline_matches(cps, name, handoff):
    got = check(cps, name, handoff=handoff, repeats=2)
    # The second run finds its build sides resident.
    first, second = got[0], got[1]
    if first["plans"]:
        assert sum(map(any, second["hits"])) >= sum(map(any, first["hits"]))
    if handoff == "device":
        assert all(r["host_bytes_moved"] == 0 for r in got[:-1]
                   if not name.startswith("grouped_multi"))
        assert got[-1]["ledger"]["fingerprint"] == 0
        assert got[-1]["ledger"]["handoff"] == 0


@pytest.mark.parametrize("order", [1, 5])
def test_every_order_matches(cps, order):
    """Two more of the star's six join orders, fused: the same rows."""
    check(cps, "star", handoff="device", order=order)


def test_negative_keys_and_entry_points(cps):
    """Negative join keys are refused on both paths; with no card,
    ``PipelineExecutor()`` raises instead of running on the CPU."""
    import torch
    t = tq.Table("t", {"k": np.array([-6, 1, 2], dtype=np.int32)})
    u = tq.Table("u", {"k": np.array([0, 1, 2], dtype=np.int32)})
    q = tq.Query(tables={"t": t, "u": u},
                 joins=(tq.Join("t", "k", "u", "k"),))
    for handoff in ("device", "host"):
        svc = te.JoinQueryService(cp=cps["torch"], num_workers=0)
        with pytest.raises(ValueError, match="negative join-key"):
            tq.PipelineExecutor(service=svc, handoff=handoff).run(q)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tq.PipelineExecutor()
