"""SSB flights 1 and 4 (or any of flights 1 to 3 and 4) through
``JoinOrderOptimizer`` and ``PipelineExecutor``: ``ssb_pipeline``'s
analysts, with the queries flights 1 and 4 need.

Traffic parameters are ``ssb_pipeline``'s.  A query's ``aggregate`` may
sum a binary expression of two columns (``["sum", ["*",
"lineorder.lo_extendedprice", "lineorder.lo_discount"]]``) and its
``group_by`` may be empty (flight 1's scalar sums), as
``bench.reference.ssb_flights`` reads them.  The tables are
``bench.data.ssb_flights``'s: SSB's with ``lo_supplycost``,
``d_yearmonthnum`` and ``d_weeknuminyear``.  A scalar query's answer is
its one row ``(sum,)``; the joined rows under it are never pulled to the
host.  Every answer is checked against ``bench.reference.ssb_flights``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..data.ssb_flights import make_tables
from ..records import Query
from ..reference.ssb import wrong_rows
from ..reference.ssb_flights import star_answer
from . import ssb_pipeline
from .ssb_pipeline import plan_signature


def operand(spec) -> str | tuple:
    """A traffic file's aggregate operand as ``repro_torch.queries`` takes
    it: a column, or an ``(op, column, column)`` tuple."""
    return spec if isinstance(spec, str) else tuple(spec)


def referenced(query: dict) -> dict:
    """``{table: [columns]}`` a query reads, an expression's operands
    included."""
    arg = query["aggregate"][1]
    refs = [arg] if isinstance(arg, str) else list(arg[1:])
    refs += [f"{t}.{c}" for t, fs in query["tables"].items() for c, *_ in fs]
    for f, fc, d, dc in query["joins"]:
        refs += [f"{f}.{fc}", f"{d}.{dc}"]
    cols: dict = {t: [] for t in query["tables"]}
    for r in refs + list(query["group_by"]):
        t, _, c = r.partition(".")
        if c not in cols[t]:
            cols[t].append(c)
    return cols


def _executor(**kw):
    """A ``PipelineExecutor`` whose result of a scalar query holds the
    query's one answer row as its columns, so that reading them pulls no
    joined rows to the host."""
    from repro_torch.queries import PipelineExecutor, agg_output_name

    class Executor(PipelineExecutor):
        def run(self, query, physical=None, **run_kw):
            res = super().run(query, physical, **run_kw)
            if query.group_by:
                return res
            return dataclasses.replace(res, _columns={
                agg_output_name(query.aggregate):
                    np.array([res.aggregate], dtype=np.int64)})

    return Executor(**kw)


class Driver(ssb_pipeline.Driver):
    def _queries(self) -> dict:
        """The traffic's queries over shared ``Table`` objects, one per
        table and set of filters (``ssb_pipeline.Driver._queries``)."""
        from repro_torch.queries import Filter, Join, Query as TQuery, Table
        cols: dict = {}
        for spec in self.specs.values():
            for t, cs in referenced(spec).items():
                cols.setdefault(t, [])
                cols[t] += [c for c in cs if c not in cols[t]]
        shared: dict = {}

        def table(name, filters):
            key = (name, tuple(map(tuple, filters)))
            if key not in shared:
                base = self.tables[name]
                shared[key] = Table(name, {c: base[c] for c in cols[name]},
                                    [Filter(c, lo, hi)
                                     for c, lo, hi in filters])
            return shared[key]

        return {name: TQuery(
                    tables={t: table(t, fs)
                            for t, fs in spec["tables"].items()},
                    joins=tuple(Join(*j) for j in spec["joins"]),
                    aggregate=(spec["aggregate"][0],
                               operand(spec["aggregate"][1])),
                    group_by=tuple(spec["group_by"]))
                for name, spec in self.specs.items()}

    def setup(self) -> None:
        """``ssb_pipeline.Driver.setup`` over ``bench.data.ssb_flights``'s
        tables and ``_executor``'s executor, with every kernel built
        first."""
        from repro_torch.core.coprocess import CoProcessor
        from repro_torch.engine import JoinQueryService, QueryPlanner
        from repro_torch.queries import JoinOrderOptimizer
        t = time.perf_counter()
        self.tables = make_tables(self.config["data"], self.seed)
        self.log(f"tables made in {time.perf_counter() - t:.3f} s")
        # Built before calibration, so that a program which cannot take a
        # query stops at once.
        self.queries = self._queries()
        # Rows a query reads: every row of every table, before filters.
        self.rows = {name: sum(len(next(iter(self.tables[t].values())))
                               for t in spec["tables"])
                     for name, spec in self.specs.items()}
        if self.device.type == "cuda":
            # A plan may change in the window (the planner learns from
            # every query): every kernel is built here, none there.
            from repro_torch.kernels._build import build_all
            build_all()
        dep = self.config["deployment"]
        cp = CoProcessor(c_device="cpu", g_device=self.device)
        t = time.perf_counter()
        planner = QueryPlanner.calibrated(cp, **dep["calibration"])
        self.log(f"calibrated in {time.perf_counter() - t:.3f} s")
        self.svc = JoinQueryService(
            cp=cp, planner=planner, num_workers=int(dep["num_workers"]),
            cache_budget_bytes=int(dep["cache_budget_bytes"]))
        self.optimizer = JoinOrderOptimizer(planner, handoff="device")
        self.executor = _executor(service=self.svc,
                                  optimizer=self.optimizer,
                                  handoff="device")
        for _ in range(int(self.traffic["warm_passes"])):
            for name in self.order:
                t = time.perf_counter()
                q = self.queries[name]
                physical = self.optimizer.optimize(q)
                t1 = time.perf_counter()
                self.executor.run(q, physical).columns
                self.log(f"warm-up {name}: optimize {t1 - t:.3f} s, run "
                         f"{time.perf_counter() - t1:.3f} s, "
                         f"{plan_signature(physical)}")
        self.svc.cp.synchronize()

    def compared(self, queries: list[Query], control: bool = False
                 ) -> dict:
        """Answers that never came, and rows of every answer that differ
        from ``bench.reference.ssb_flights``'s; with ``control`` the
        control's answers (the sums wrapped to int32) stand in for the
        program's."""
        missing = sum(q.error is not None for q in queries)
        names = {n for n, _ in self.answers}
        want = {name: star_answer(self.tables, self.specs[name])
                for name in names}
        ctrl = ({name: star_answer(self.tables, self.specs[name],
                                   wrap32=True) for name in names}
                if control else {})
        wrong = sum(wrong_rows(ctrl[name] if control else got, want[name])
                    for name, got in self.answers)
        return {"missing_answers": (missing, 0),
                "wrong_rows": (wrong, 0),
                "answers_checked": (len(self.answers), None)}
