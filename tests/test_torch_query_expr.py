"""Sums over an expression of two columns (``plan.EXPR_OPS``) through the
port's query layer on the CPU: ``JoinOrderOptimizer`` ->
``PipelineExecutor`` -> ``JoinQueryService``, in the scalar and the
grouped sink, held to ``plan.py``'s NumPy oracle and to the benchmark's
plain PyTorch reference (``bench/reference/ssb_flights.py``); the
group-by's exact int64 path through kernel F's plain version; the
errors a malformed expression raises; and the executor's ``sink`` and
``scan.fp`` spans and ``scan_upload`` bytes, which the benchmark's
readers read."""
import numpy as np
import pytest
import torch

import repro_torch.core as tc
import repro_torch.engine as te
import repro_torch.queries as tq
from bench import harness
from bench.records import Query as BenchQuery
from bench.records import Readings
from bench.reference.ssb_flights import star_answer

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
NO_FEEDBACK = 1 << 40


@pytest.fixture(scope="module")
def cp():
    return tc.CoProcessor(c_device="cpu", g_device="cpu")


def _executor(cp, handoff="device"):
    svc = te.JoinQueryService(
        cp=cp, planner=te.QueryPlanner(delta=0.25,
                                       min_feedback_items=NO_FEEDBACK),
        num_workers=0)
    opt = tq.JoinOrderOptimizer(svc.planner, handoff=handoff)
    return tq.PipelineExecutor(service=svc, optimizer=opt, handoff=handoff)


def _star(dims: int, *, fact_rows: int = 3000, seed: int = 0,
          filters: bool = True):
    """A star over ``dims`` dimensions: fact ``F`` with foreign keys
    ``fk<i>``, two value columns (``x`` over the whole int32 range, ``y``
    within 2^20: their products leave int32 in single rows, and a few
    thousand of them still sum within int64), a low-cardinality
    ``g``; dimension ``D<i>`` with a unique ``id`` (some keys left out, so
    some fact rows find no match) and an attribute ``a``.  Returns the
    tables as ``{name: {column: array}}`` and the range filters."""
    rng = np.random.default_rng(seed)
    tables = {"F": {"x": rng.integers(I32_MIN, I32_MAX, fact_rows,
                                      dtype=np.int64).astype(np.int32),
                    "y": rng.integers(-2**20, 2**20, fact_rows,
                                      dtype=np.int32),
                    "g": rng.integers(0, 3, fact_rows, dtype=np.int32)}}
    flt = {"F": [["g", 0, 2]] if filters else []}
    for i in range(dims):
        n = 40 + 17 * i
        tables["F"][f"fk{i}"] = rng.integers(0, n + 5, fact_rows,
                                             dtype=np.int32)
        tables[f"D{i}"] = {"id": rng.permutation(n).astype(np.int32),
                           "a": rng.integers(0, 4, n, dtype=np.int32)}
        flt[f"D{i}"] = [["a", 0, 3]] if filters and i % 2 == 0 else []
    return tables, flt


def _spec(tables, flt, aggregate, group_by=()):
    """The query as the benchmark's traffic files write it."""
    dims = [t for t in tables if t != "F"]
    return {"tables": {t: flt[t] for t in tables},
            "joins": [["F", f"fk{i}", d, "id"] for i, d in enumerate(dims)],
            "group_by": list(group_by), "aggregate": list(aggregate)}


def _query(tables, spec):
    agg = spec["aggregate"]
    operand = agg[1] if isinstance(agg[1], str) else tuple(agg[1])
    return tq.Query(
        tables={t: tq.Table(t, cols, [tq.Filter(*f)
                                      for f in spec["tables"][t]])
                for t, cols in tables.items()},
        joins=tuple(tq.Join(*j) for j in spec["joins"]),
        aggregate=(agg[0], operand), group_by=tuple(spec["group_by"]))


def _answer(res, query):
    """The executor's answer in the reference's form."""
    if not query.group_by:
        return [(res.aggregate,)]
    cols = res.columns
    name = tq.agg_output_name(query.aggregate)
    keys = [cols[q].astype(np.int64) for q in query.group_by]
    return sorted(tuple(int(v) for v in row)
                  for row in zip(*keys, cols[name].astype(np.int64)))


def _check(res, query, tables, spec):
    rows, agg = tq.reference_execute(query)
    if query.group_by:
        assert np.array_equal(res.rows_array(), rows)
    else:
        assert res.aggregate == agg
    assert _answer(res, query) == star_answer(tables, spec)


@pytest.mark.parametrize("handoff", ["device", "host"])
@pytest.mark.parametrize("group_by", [(), ("D0.a",), ("D0.a", "F.g")],
                         ids=["scalar", "grouped", "grouped2"])
@pytest.mark.parametrize("op", tq.EXPR_OPS)
def test_expression_sums_match_the_oracle_and_the_reference(
        cp, op, group_by, handoff):
    tables, flt = _star(2, seed=len(group_by))
    spec = _spec(tables, flt, ["sum", [op, "F.x", "D1.id"]]
                 if op == "+" else ["sum", [op, "F.x", "F.y"]], group_by)
    query = _query(tables, spec)
    ex = _executor(cp, handoff)
    try:
        res = ex.run(query)
    finally:
        ex.close()
    assert res.rows > 0
    _check(res, query, tables, spec)
    if op == "*":
        # Products, and the sums of every group, leave int32.
        want = star_answer(tables, spec)
        assert all(abs(row[-1]) > 2**31 for row in want)


def test_exact_at_the_ends_of_int64(cp):
    """Products at the ends of the int32 range (2^62, -2^62 + 2^31), a
    group summing to 2^63 - 2^32 + 1, negative groups, and groups of one
    row: each exact, through the grouped sink (multi-column keys) and the
    scalar one."""
    x = np.array([I32_MIN, I32_MAX, I32_MIN, -5, 7, I32_MAX, 3, I32_MIN],
                 np.int32)
    y = np.array([I32_MIN, I32_MAX, I32_MAX, 9, -11, I32_MIN, 0, 1],
                 np.int32)
    g = np.array([0, 0, 1, 1, 1, 2, 3, 4], np.int32)
    tables = {"F": {"x": x, "y": y, "g": g,
                    "fk0": np.arange(8, dtype=np.int32)},
              "D0": {"id": np.arange(8, dtype=np.int32)[::-1].copy(),
                     "a": (np.arange(8) % 2).astype(np.int32)}}
    flt = {"F": [], "D0": []}
    for group_by in (("F.g", "D0.a"), ("F.g",), ()):
        spec = _spec(tables, flt, ["sum", ["*", "F.x", "F.y"]], group_by)
        query = _query(tables, spec)
        ex = _executor(cp)
        try:
            res = ex.run(query)
        finally:
            ex.close()
        _check(res, query, tables, spec)
    sums = {row[0]: row[-1] for row in star_answer(
        tables, _spec(tables, flt, ["sum", ["*", "F.x", "F.y"]], ["F.g"]))}
    assert sums[0] == 2**63 - 2**32 + 1
    assert sums[1] == -(2**62) + 2**31 - 45 - 77
    assert sums[2] == -(2**62) + 2**31 and sums[4] == I32_MIN


@pytest.mark.parametrize("schedule, ratios", [
    (None, (0.0, 0.0)), (None, (0.0, 0.5)), ((2,), (0.5, 0.5)),
    ((2, 1), (0.0, 1.0))])
def test_groupby_sums_int64_values_exactly(cp, schedule, ratios):
    """Kernel F's plain version takes int64 values as two int32 words, on
    every path of ``groupby_coprocessed`` (one group, the row split and
    its merge, partitioned ownership), pads included."""
    from repro_torch.core.relation import Relation
    from repro_torch.ops.groupby import groupby_ref
    rng = np.random.default_rng(3)
    n = 3000
    keys = rng.integers(0, 50, n, dtype=np.int32)
    # Products past int32 whose group sums stay within int64.
    vals = (rng.integers(I32_MIN, I32_MAX, n).astype(np.int64)
            * rng.integers(-2**24, 2**24, n))
    rid = np.arange(n, dtype=np.int32)
    rid[::7] = -1                                 # pads: left out
    rel = Relation(torch.from_numpy(rid), torch.from_numpy(keys))
    got, _ = cp.groupby(rel, torch.from_numpy(vals), schedule=schedule,
                        partition_ratio=ratios[0], agg_ratio=ratios[1])
    live = rid >= 0
    want = groupby_ref(keys[live], vals[live])
    got = got.sorted()
    assert np.array_equal(got.keys, want.keys)
    assert np.array_equal(got.counts, want.counts)
    assert got.sums.dtype == np.int64
    assert np.array_equal(got.sums, want.sums)
    with pytest.raises(ValueError, match="wrap32"):
        cp.groupby(rel, torch.from_numpy(vals), partition_ratio=0.0,
                   agg_ratio=0.0, wrap32=True)


@pytest.mark.parametrize("group_by", [(), ("D1.a", "D3.a")],
                         ids=["scalar", "grouped"])
def test_a_four_edge_star_in_every_order(cp, group_by):
    """Q4.x's shape: four edges, so ``optimize`` prices all 24 orders;
    every one of them gives the oracle's and the reference's answer."""
    tables, flt = _star(4, fact_rows=1500, seed=9)
    spec = _spec(tables, flt, ["sum", ["-", "F.x", "F.y"]], group_by)
    query = _query(tables, spec)
    ex = _executor(cp)
    try:
        orders = ex.optimizer.enumerate_orders(query)
        assert len(orders) == 24
        assert ex.optimizer.exhaustive_joins >= 4
        for order in orders:
            res = ex.run(query, ex.optimizer.price_order(query, order))
            _check(res, query, tables, spec)
    finally:
        ex.close()


def _tiny_tables():
    tables, _ = _star(1, fact_rows=64)
    tables["S"] = {"id": np.arange(10, dtype=np.int32)}
    tables["F"]["fk1"] = tables["F"]["g"]
    return {t: tq.Table(t, cols) for t, cols in tables.items()}


@pytest.mark.parametrize("aggregate, kw, match", [
    (("sum", ("*", "F.x", "F.nope")), {}, "unknown column"),
    (("sum", ("*", "F.x", "Z.x")), {}, "unknown column"),
    (("sum", ("*", "F.x", "S.id")), {}, "semi/anti-consumed"),
    (("sum", ("/", "F.x", "F.y")), {}, "neither a column"),
    (("sum", ("*", "F.x")), {}, "neither a column"),
    (("sum", ["*", "F.x", "F.y"]), {}, "neither a column"),
    (("min", ("*", "F.x", "F.y")), {}, "only sum"),
    (("avg", ("+", "F.x", "F.y")), {}, "only sum"),
    (("sum", ("-", "F.x", "F.y")), {"wrap32": True}, "wrap32"),
])
def test_malformed_expressions_raise(aggregate, kw, match):
    with pytest.raises(ValueError, match=match):
        tq.Query(tables=_tiny_tables(),
                 joins=(tq.Join("F", "fk0", "D0", "id"),
                        tq.Join("F", "fk1", "S", "id", kind="semi")),
                 aggregate=aggregate, group_by=("D0.a",), **kw)


def test_expression_output_name():
    assert tq.agg_output_name(("sum", ("*", "F.x", "F.y"))) == \
        "~sum(F.x*F.y)"
    assert tq.agg_output_name(("sum", "F.x")) == "~sum(F.x)"
    cols = {"F.x": np.array([I32_MAX, -3], np.int32),
            "F.y": np.array([I32_MAX, 5], np.int32)}
    assert tq.apply_aggregate(cols, ("sum", ("*", "F.x", "F.y"))) == \
        I32_MAX * I32_MAX - 15
    assert tq.apply_aggregate(cols, ("sum", ("-", "F.x", "F.y"))) == -8


def _q41_driver():
    """The benchmark's flights14 driver, cut to CPU size and set up (its
    warm pass runs every query once)."""
    from bench.drivers.ssb_flights import Driver
    _, _, config, traffic = harness.cell_spec("ssb_sf2.flights14")
    config["data"]["rows"] = {"lineorder": 20000, "customer": 300,
                              "supplier": 40, "part": 2000, "date": 2556}
    config["deployment"]["calibration"] = {"n": 1 << 10, "reps": 1,
                                           "delta": 0.1}
    driver = Driver(config, traffic, 2**31 + 5, "cpu")
    driver.setup()
    return driver


def test_a_traced_q4_query_records_the_sink_and_scan_spans():
    d = _q41_driver()
    try:
        svc = d.svc
        q = d.queries["q4.1"]
        physical = d.optimizer.optimize(q)
        before = svc.ledger.by_cause()
        t_run = svc.tracer.now()
        res = d.executor.run(q, physical)
        t_end = svc.tracer.now()
        spans = [s for s in svc.tracer.spans() if s.t0 >= t_run]
        ledger = {k: v - before.get(k, 0)
                  for k, v in svc.ledger.by_cause().items()}
    finally:
        d.release()
    sinks = [s for s in spans if s.name == "sink"]
    assert len(sinks) == 1
    assert sinks[0].attrs["kind"] == "grouped"
    assert sinks[0].attrs["rows"] == res.outcomes[-1].result.counts.sum()
    # A base key column is hashed once per run, on its memo miss: the
    # stage token asks again and hits the memo.
    base_keys = {col for s in physical.stages
                 for src, col in ((s.build_input, s.build_col),
                                  (s.probe_input, s.probe_col))
                 if isinstance(src, str)}
    fps = [s.attrs["column"] for s in spans if s.name == "scan.fp"]
    assert sorted(fps) == sorted(base_keys)
    # Every raw column a scan view read, uploaded once: the stages' keys
    # (a later stage's through the chain of the view before it), the
    # group-by keys and the expression's two operands.
    read = {c for s in physical.stages for c in (s.build_col, s.probe_col)}
    read |= set(q.group_by) | set(q.aggregate[1][1:])
    raw = sum(q.tables[r.partition(".")[0]].columns[
        r.partition(".")[2]].nbytes for r in read)
    assert ledger["scan_upload"] == raw
    assert ledger["handoff"] == ledger["fingerprint"] == 0
    record = BenchQuery(t_run, t_end, 1, spans={"run": (t_run, t_end)})
    readings = Readings([record], spans, ledger, {}, {})
    values = {m: harness.reader(m)(readings) for m in (
        "executor.sink_ms", "executor.scan_fp_ms",
        "executor.scan_upload_MB_per_query")}
    assert all(v is not None and v > 0 for v in values.values()), values
    assert values["executor.scan_upload_MB_per_query"] == raw / 1e6


def test_a_join_through_the_service_records_no_executor_spans(cp):
    """The paper's join path (``JoinQueryService`` alone) records neither
    span nor the ``scan_upload`` cause."""
    from repro_torch.core.relation import Relation
    svc = te.JoinQueryService(cp=cp, num_workers=0)
    try:
        n = 1024
        keys = torch.randperm(n, generator=torch.Generator().manual_seed(1))
        rel = Relation(torch.arange(n, dtype=torch.int32),
                       keys.to(torch.int32))
        svc.execute(te.JoinQuery(rel, rel, max_out=2 * n))
        names = {s.name for s in svc.tracer.spans()}
        assert "query" in names
        assert not names & {"sink", "scan.fp"}
        assert "scan_upload" not in svc.ledger.by_cause()
    finally:
        svc.close()
