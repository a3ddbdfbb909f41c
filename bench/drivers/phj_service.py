"""Clients that submit two-relation joins to one ``JoinQueryService``.

Traffic parameters (``traffic/<cell>.json``):

* ``clients``: closed-loop clients; each submits its next query only when
  the last one has answered;
* ``inputs``: ``"fresh"`` makes a new (R, S) pair for every query, from
  the query's own stream of the seed; ``"pool"`` re-submits the same
  ``pool`` pairs, made in set-up, in a seeded order;
* ``warm_passes``: set-up queries before the window (fresh pairs from a
  stream of their own, or passes over the pool);
* ``check``: ``sample`` queries, drawn from the seed among the first
  ``of_first``, have their answers kept and held to the reference once
  the window has closed.

The configuration gives the relations (``data.build``, ``data.probe``:
rows and key spec, see ``bench.data.relations``) and the deployment: the
C group on the host, the G group on the card, the service's workers and
cache budget, and ``QueryPlanner.calibrated``'s arguments.
"""
from __future__ import annotations

import itertools
import threading
import time

import numpy as np
import torch

from ..data.relations import make_relation, stream_seed
from ..records import Query, Stage
from ..reference.join import (first_match_pairs, join_pairs, pair_codes,
                              wrong_pairs)

# An answer may come this long after the window closes; one that has not
# come by then never comes.
LATE_S = 60.0


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 log=lambda *a: None):
        self.config, self.traffic = config, traffic
        self.log = log
        self.seed, self.device = int(seed), torch.device(device)
        data = config["data"]
        self.build_spec, self.probe_spec = data["build"], data["probe"]
        self.rows = int(self.build_spec["rows"]) + int(self.probe_spec["rows"])
        check = traffic["check"]
        rng = np.random.default_rng(stream_seed(seed, "check"))
        self.sample = set(rng.choice(int(check["of_first"]),
                                     int(check["sample"]), replace=False)
                          .tolist())
        self.kept: dict = {}              # query index -> answer codes
        self.pool: list = []
        self.svc = None

    # -- inputs -------------------------------------------------------------
    def _stream(self, index: int):
        if self.traffic["inputs"] == "pool":
            slot = np.random.default_rng(
                stream_seed(self.seed, "order", index)).integers(
                    int(self.traffic["pool"]))
            return ("pool", int(slot))
        return ("query", index)

    def _tensors(self, stream):
        r = make_relation(self.build_spec, self.device, self.seed, *stream,
                          "R")
        s = make_relation(self.probe_spec, self.device, self.seed, *stream,
                          "S")
        return r, s

    def _pair(self, stream):
        from repro_torch.core.relation import Relation
        (rr, rk), (sr, sk) = self._tensors(stream)
        return Relation(rr, rk), Relation(sr, sk)

    # -- set-up -------------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.core.coprocess import CoProcessor
        from repro_torch.engine import JoinQueryService, QueryPlanner
        dep = self.config["deployment"]
        cp = CoProcessor(c_device="cpu", g_device=self.device)
        t = time.perf_counter()
        planner = QueryPlanner.calibrated(cp, **dep["calibration"])
        self.log(f"calibrated in {time.perf_counter() - t:.3f} s")
        self.svc = JoinQueryService(
            cp=cp, planner=planner, num_workers=int(dep["num_workers"]),
            cache_budget_bytes=int(dep["cache_budget_bytes"]))
        if self.traffic["inputs"] == "pool":
            self.pool = [self._pair(("pool", i))
                         for i in range(int(self.traffic["pool"]))]
            warm = [p for _ in range(int(self.traffic["warm_passes"]))
                    for p in self.pool]
        else:
            warm = [self._pair(("warm", i))
                    for i in range(int(self.traffic["warm_passes"]))]
        from repro_torch.engine import JoinQuery
        t = time.perf_counter()
        for i, (r, s) in enumerate(warm):
            o = self.svc.submit(JoinQuery(r, s, query_id=-1 - i,
                                          tag="warm-up"))()
            self.log(f"warm-up {i}: {o.plan.algorithm}/{o.plan.scheme} "
                     f"schedule {o.plan.schedule} ratios "
                     f"{o.plan.partition_ratio}/{o.plan.join_ratio}, "
                     f"phases {o.timing.phase_s}")
        del warm, o
        self.svc.cp.synchronize()
        self.log(f"warmed up in {time.perf_counter() - t:.3f} s")

    # -- the window ---------------------------------------------------------
    def window(self, seconds: float) -> list[Query]:
        from repro_torch.engine import JoinQuery
        counter = itertools.count()
        out: list[Query] = []
        lock = threading.Lock()
        t_end = time.perf_counter() + seconds

        def client():
            while time.perf_counter() < t_end:
                index = next(counter)
                stream = self._stream(index)
                t_in = time.perf_counter()
                r, s = (self.pool[stream[1]] if stream[0] == "pool"
                        else self._pair(stream))
                rec = Query(time.perf_counter(), 0.0, self.rows)
                rec.spans["make_inputs"] = (t_in, rec.t_submit)
                try:
                    wait = self.svc.submit(JoinQuery(
                        r, s, query_id=index, tag=stream[0]))
                    outcome = wait(max(0.0, t_end - time.perf_counter())
                                   + LATE_S)
                    rec.t_done = time.perf_counter()
                    res = outcome.result
                    if index in self.sample:
                        c = int(res.count)
                        self.kept[index] = pair_codes(res.probe_rid[:c],
                                                      res.build_rid[:c])
                    st = Stage.of(outcome, r.size, s.size)
                    rec.stages.append(st)
                    rec.plan = (f"{st.algorithm}/{st.scheme} {st.schedule} "
                                f"{st.partition_ratio}/{st.join_ratio} hits "
                                f"{st.build_layout_hit}/{st.probe_layout_hit}")
                    outcome.result = outcome.trace = None
                except Exception as e:        # a failed query is counted
                    rec.error = repr(e)
                    rec.t_done = time.perf_counter()
                with lock:
                    out.append(rec)

        threads = [threading.Thread(target=client, name=f"bench-client-{i}")
                   for i in range(int(self.traffic["clients"]))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return out

    def release(self) -> None:
        """Stop the service and free the program's state."""
        self.svc.close()
        self.svc = None
        self.pool = []

    # -- the check ----------------------------------------------------------
    def compared(self, queries: list[Query], control: bool = False
                 ) -> dict:
        """The numbers held to their limits: answers that never came, and
        pairs of the kept answers that differ from the reference's.  With
        ``control`` the control's answer stands in for the program's."""
        missing = sum(q.error is not None for q in queries)
        wrong, refs = 0, {}
        for stream, got in sorted(((self._stream(i), got)
                                   for i, got in self.kept.items()),
                                  key=lambda x: x[0]):
            if stream not in refs:      # pool slots recur: one reference each
                (rr, rk), (sr, sk) = self._tensors(stream)
                refs = {stream: (join_pairs(rr, rk, sr, sk),
                                 first_match_pairs(rr, rk, sr, sk)
                                 if control else got)}
            want, ctrl = refs[stream]
            wrong += wrong_pairs(ctrl if control else got, want)
        return {"missing_answers": (missing, 0),
                "wrong_pairs": (wrong, 0),
                "answers_checked": (len(self.kept), None)}
