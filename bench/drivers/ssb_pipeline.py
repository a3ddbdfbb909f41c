"""Analysts running star queries through ``JoinOrderOptimizer`` and
``PipelineExecutor`` over one ``JoinQueryService``.

Traffic parameters (``traffic/<cell>.json``):

* ``clients``: closed-loop clients; each cycles through ``order`` from a
  seeded starting point, running ``JoinOrderOptimizer.optimize`` and then
  ``PipelineExecutor.run`` for each query;
* ``queries``: each query as data, in ``bench.reference.ssb``'s form
  (tables with their range filters, join edges, group-by, sum);
* ``warm_passes``: passes over ``order`` in set-up.

The configuration gives the data generator (``data``, see
``bench.data.ssb``) and the deployment, as for ``phj_service``; the base
tables live on the host as NumPy columns, and every answer is checked.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..data.relations import stream_seed
from ..data.ssb import make_tables
from ..records import Query, Stage
from ..reference.ssb import star_answer, wrong_rows


def referenced(query: dict) -> dict:
    """``{table: [columns]}`` a query reads."""
    cols: dict = {t: [] for t in query["tables"]}
    refs = [f"{t}.{c}" for t, fs in query["tables"].items() for c, *_ in fs]
    for f, fc, d, dc in query["joins"]:
        refs += [f"{f}.{fc}", f"{d}.{dc}"]
    refs += list(query["group_by"]) + [query["aggregate"][1]]
    for r in refs:
        t, _, c = r.partition(".")
        if c not in cols[t]:
            cols[t].append(c)
    return cols


def plan_signature(physical) -> str:
    """The join order and each stage's plan, in one line."""
    def src(x):
        return x if isinstance(x, str) else f"#{x}"
    def ratios(p):
        r = ((p.partition_ratio, p.join_ratio) if p.algorithm == "phj"
             else tuple(p.build_ratios) + tuple(p.probe_ratios))
        return ",".join(f"{x:g}" for x in r)
    stages = [f"{src(s.build_input)}x{src(s.probe_input)}"
              f"[{s.plan.algorithm}/{s.plan.scheme} {ratios(s.plan)}]"
              for s in physical.stages]
    sink = physical.agg_plan
    return " ".join(stages + ([f"sink[{sink.scheme}]"] if sink else []))


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 log=lambda *a: None):
        self.config, self.traffic = config, traffic
        self.log = log
        self.seed, self.device = int(seed), torch.device(device)
        self.specs = traffic["queries"]
        self.order = list(traffic["order"])
        self.answers: list = []             # (query name, answer rows)
        self.tables = None
        self.svc = None

    def _queries(self) -> dict:
        """The traffic's queries over shared ``Table`` objects: one per
        table and set of filters, holding every column any query reads,
        as a database holds one lineorder whatever the query."""
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
                    aggregate=tuple(spec["aggregate"]),
                    group_by=tuple(spec["group_by"]))
                for name, spec in self.specs.items()}

    def setup(self) -> None:
        from repro_torch.core.coprocess import CoProcessor
        from repro_torch.engine import JoinQueryService, QueryPlanner
        from repro_torch.queries import JoinOrderOptimizer, PipelineExecutor
        t = time.perf_counter()
        self.tables = make_tables(self.config["data"], self.seed)
        self.log(f"tables made in {time.perf_counter() - t:.3f} s")
        # Rows a query reads: every row of every table, before filters.
        self.rows = {name: sum(len(next(iter(self.tables[t].values())))
                               for t in spec["tables"])
                     for name, spec in self.specs.items()}
        dep = self.config["deployment"]
        cp = CoProcessor(c_device="cpu", g_device=self.device)
        t = time.perf_counter()
        planner = QueryPlanner.calibrated(cp, **dep["calibration"])
        self.log(f"calibrated in {time.perf_counter() - t:.3f} s")
        self.svc = JoinQueryService(
            cp=cp, planner=planner, num_workers=int(dep["num_workers"]),
            cache_budget_bytes=int(dep["cache_budget_bytes"]))
        self.optimizer = JoinOrderOptimizer(planner, handoff="device")
        self.executor = PipelineExecutor(service=self.svc,
                                         optimizer=self.optimizer,
                                         handoff="device")
        self.queries = self._queries()
        for _ in range(int(self.traffic["warm_passes"])):
            for name in self.order:
                t = time.perf_counter()
                q = self.queries[name]
                physical = self.optimizer.optimize(q)
                t1 = time.perf_counter()
                res = self.executor.run(q, physical)
                res.columns
                self.log(f"warm-up {name}: optimize {t1 - t:.3f} s, run "
                         f"{time.perf_counter() - t1:.3f} s, "
                         f"{plan_signature(physical)}")
        del res
        self.svc.cp.synchronize()

    def _answer(self, name: str, columns: dict) -> list:
        spec = self.specs[name]
        keys = list(spec["group_by"])
        (agg,) = [c for c in columns if c not in keys]
        mat = np.stack([np.asarray(columns[c], dtype=np.int64)
                        for c in keys + [agg]], axis=1)
        return sorted(tuple(int(v) for v in row) for row in mat)

    def window(self, seconds: float) -> list[Query]:
        out: list[Query] = []
        lock = threading.Lock()
        t_end = time.perf_counter() + seconds
        start = np.random.default_rng(
            stream_seed(self.seed, "order")).integers(len(self.order))

        def client(ci: int):
            for i in range(int(start) + ci, 1 << 62):
                if time.perf_counter() >= t_end:
                    return
                name = self.order[i % len(self.order)]
                q = self.queries[name]
                rec = Query(time.perf_counter(), 0.0, self.rows[name],
                            kind=name)
                try:
                    physical = self.optimizer.optimize(q)
                    rec.plan = plan_signature(physical)
                    t1 = time.perf_counter()
                    res = self.executor.run(q, physical)
                    t2 = time.perf_counter()
                    cols = res.columns
                    rec.t_done = time.perf_counter()
                    answer = self._answer(name, cols)
                    rec.spans = {"optimize": (rec.t_submit, t1),
                                 "run": (t1, t2)}
                    rec.stages = [Stage.of(o) for o in res.outcomes]
                    for o in res.outcomes:
                        o.result = o.trace = None
                    del res
                    with lock:
                        self.answers.append((name, answer))
                except Exception as e:        # a failed query is counted
                    rec.error = repr(e)
                    rec.t_done = time.perf_counter()
                with lock:
                    out.append(rec)

        threads = [threading.Thread(target=client, args=(i,),
                                    name=f"bench-client-{i}")
                   for i in range(int(self.traffic["clients"]))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return out

    def release(self) -> None:
        self.executor.close()
        self.svc = self.executor = self.optimizer = self.queries = None

    def compared(self, queries: list[Query], control: bool = False
                 ) -> dict:
        """Answers that never came, and rows of every answer that differ
        from the reference's; with ``control`` the control's answers (sums
        in int32) stand in for the program's."""
        missing = sum(q.error is not None for q in queries)
        want = {name: star_answer(self.tables, self.specs[name])
                for name in {n for n, _ in self.answers}}
        if control:
            ctrl = {name: star_answer(self.tables, self.specs[name],
                                      sum_dtype=np.int32) for name in want}
        wrong = sum(wrong_rows(ctrl[name] if control else got, want[name])
                    for name, got in self.answers)
        return {"missing_answers": (missing, 0),
                "wrong_rows": (wrong, 0),
                "answers_checked": (len(self.answers), None)}
