"""Workload generation: streams of heterogeneous join queries.

Scenario catalog (each yields ``JoinQuery`` instances with varying relation
sizes, skew, and selectivity — the axes the paper sweeps in §5):

  * ``uniform``     — both sides uniform keys, sizes drawn from a small
                      grid around the base size (bounds distinct shapes).
  * ``zipf``        — PK build side, probe keys Zipf-distributed over it
                      (skewed foreign keys: matches stay ≤ |S|).
  * ``selectivity`` — PK build side, probe selectivity cycling through the
                      paper's {12.5%, 50%, 100%} (§5.5).
  * ``hot_table``   — fresh probes against a small pool of recurring build
                      relations: the scenario the build-table cache exists
                      for (every repeat skips the build phase).
  * ``star``        — multi-join traffic: a star-shaped *logical query*
                      (fresh fact table, dimensions drawn from a recurring
                      hot pool) for ``repro_torch.queries.PipelineExecutor``
                      — the engine sees its stages as ordinary join
                      queries, so dimension reuse hits the build-side
                      caches.
  * ``analytic``    — the ops-subsystem mix: star-shaped logical queries
                      whose edges cycle through semi/anti/outer variants
                      and whose sink cycles through group-by aggregates
                      (count/sum/min/max/avg over the fact measure).

``make_workload`` assembles a weighted mix; ``MIXES`` names the standard
mixes the benchmarks and tests use.  ``star`` produces ``queries.Query``
objects (not ``JoinQuery``), so it is replayed through the query-pipeline
executor rather than ``stream``.

``open_loop`` extends the generator into an open-loop traffic simulator:
queries arrive on a Poisson (or bursty on/off) process, tagged with a
tenant drawn from a mix (optionally Zipf-skewed toward a hot tenant) and
that tenant's deadline — the arrival schedule the ``slo_bench`` benchmark
replays against the service's admission control.

Counterpart of ``repro/engine/workload.py``: the same seed gives the same
relations bit for bit, made on ``device`` (the card unless the caller
asks for the CPU), and the same ``star`` / ``analytic`` queries, whose
tables are NumPy columns on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.relation import (Relation, probe_with_selectivity,
                             resolve_device, uniform_relation,
                             unique_relation)
from .service import JoinQuery

# Size multipliers: a deliberately small grid so repeated shapes reuse
# plans and cached state instead of a fresh shape per query.
SIZE_GRID = (0.5, 1.0, 2.0)

MIXES = {
    "uniform": (("uniform", 1.0),),
    "zipf": (("zipf", 1.0),),
    "selectivity": (("selectivity", 1.0),),
    "hot_table": (("hot_table", 1.0),),
    # The headline mixed workload: enough hot-table traffic that cache
    # reuse matters, plus every other axis of heterogeneity.
    "mixed": (("uniform", 0.2), ("zipf", 0.2), ("selectivity", 0.2),
              ("hot_table", 0.4)),
}


def zipf_keys(rng: np.random.Generator, n: int, key_range: int,
              theta: float = 1.3) -> np.ndarray:
    """Zipf-distributed int32 keys folded into [0, key_range)."""
    return ((rng.zipf(theta, size=n) - 1) % key_range).astype(np.int32)


def _size(rng: np.random.Generator, base: int) -> int:
    return max(256, int(base * rng.choice(SIZE_GRID)))


class WorkloadGenerator:
    """Deterministic (seeded) query stream over the scenario catalog."""

    def __init__(self, base_tuples: int = 65536, *, seed: int = 0,
                 hot_pool: int = 3, zipf_theta: float = 1.3,
                 device="cuda"):
        self.base = int(base_tuples)
        self.rng = np.random.default_rng(seed)
        self.zipf_theta = zipf_theta
        self.device = resolve_device(device)
        # Hot build relations are materialized once and re-submitted, so
        # their fingerprints recur (and their generation cost isn't paid
        # per query).
        self._hot_pool: list[Relation] = [
            unique_relation(_size(self.rng, self.base), seed=1000 + i,
                            device=self.device)
            for i in range(hot_pool)]
        self._sel_cycle = (0.125, 0.5, 1.0)
        self._sel_i = 0
        # Star scenario: recurring dimension tables + a short selectivity
        # cycle (repeats make the per-stage build sides cacheable).
        self._star_pool: list = []
        self._star_sels = (None, 0.1, 0.4)
        self._star_i = 0
        # Analytic scenario: cycle variants and grouped aggregates so a
        # replayed stream exercises every operator the ops subsystem adds.
        self._variant_cycle = (("inner", "semi"), ("inner", "anti"),
                               ("left_outer", "inner"), ("semi", "inner"))
        self._agg_cycle = (("count",), ("sum", "F.m"), ("min", "F.m"),
                           ("max", "F.m"), ("avg", "F.m"))
        self._analytic_i = 0
        self._qid = 0

    # -- scenarios ----------------------------------------------------------
    def uniform(self) -> JoinQuery:
        nb, ns = _size(self.rng, self.base), _size(self.rng, self.base)
        b = uniform_relation(nb, seed=int(self.rng.integers(1 << 30)),
                             device=self.device)
        s = uniform_relation(ns, key_range=nb,
                             seed=int(self.rng.integers(1 << 30)),
                             device=self.device)
        # Uniform build keys collide, so matches can exceed |S| slightly.
        return self._query(b, s, "uniform", max_out=8 * ns + 1024)

    def zipf(self) -> JoinQuery:
        nb, ns = _size(self.rng, self.base), _size(self.rng, self.base)
        b = unique_relation(nb, seed=int(self.rng.integers(1 << 30)),
                            device=self.device)
        keys = zipf_keys(self.rng, ns, nb, self.zipf_theta)
        return self._query(b, self._probe(keys), "zipf",
                           max_out=ns + 64)  # PK side: ≤ |S|

    def selectivity(self) -> JoinQuery:
        sel = self._sel_cycle[self._sel_i % len(self._sel_cycle)]
        self._sel_i += 1
        nb, ns = _size(self.rng, self.base), _size(self.rng, self.base)
        b = unique_relation(nb, seed=int(self.rng.integers(1 << 30)),
                            device=self.device)
        s = probe_with_selectivity(b, ns, selectivity=sel,
                                   seed=int(self.rng.integers(1 << 30)))
        return self._query(b, s, f"sel_{sel}", max_out=ns + 64)

    def hot_table(self) -> JoinQuery:
        b = self._hot_pool[int(self.rng.integers(len(self._hot_pool)))]
        ns = _size(self.rng, self.base)
        keys = zipf_keys(self.rng, ns, b.size, self.zipf_theta)
        return self._query(b, self._probe(keys), "hot_table",
                           max_out=ns + 64)

    def star(self, num_dims: int = 3):
        """A star-shaped logical ``repro_torch.queries.Query`` (multi-join).

        The fact table is fresh per call; the dimensions come from a
        recurring pool with a small cycle of filter selectivities, so
        replaying stars through ``PipelineExecutor`` produces repeated
        build sides — the cross-operator reuse the caches exist for.
        """
        from ..queries import make_star_query
        self._ensure_star_pool()
        idx = sorted(self.rng.choice(len(self._star_pool),
                                     size=min(num_dims,
                                              len(self._star_pool)),
                                     replace=False))
        dims = [self._star_pool[i] for i in idx]
        sels = [self._star_sels[(self._star_i + k) % len(self._star_sels)]
                for k in range(len(dims))]
        self._star_i += 1
        self._qid += 1
        return make_star_query(
            _size(self.rng, 2 * self.base), [d.size for d in dims],
            selectivities=sels, seed=int(self.rng.integers(1 << 30)),
            aggregate=("count",), dim_tables=dims)

    def _ensure_star_pool(self):
        if self._star_pool:
            return
        from ..queries import Table
        rng = np.random.default_rng(int(self.rng.integers(1 << 30)))
        for i in range(len(self._hot_pool)):
            n = _size(rng, max(1024, self.base // 2))
            self._star_pool.append(Table(f"D{i}", {
                "id": rng.permutation(n).astype(np.int32),
                "a": rng.integers(0, 1000, size=n, dtype=np.int32)}))

    def analytic(self, num_dims: int = 2):
        """A star query with join variants and a group-by sink.

        Two dimensions from the recurring pool, edge kinds and the grouped
        aggregate cycling deterministically; grouped on the fact table's
        low-cardinality ``g`` attribute so results stay small however the
        joins land.  Replayed through ``PipelineExecutor`` like ``star``.
        """
        from ..queries import make_star_query
        self._ensure_star_pool()
        i = self._analytic_i
        self._analytic_i += 1
        idx = sorted(self.rng.choice(len(self._star_pool),
                                     size=min(num_dims,
                                              len(self._star_pool)),
                                     replace=False))
        dims = [self._star_pool[k] for k in idx]
        kinds = list(self._variant_cycle[i % len(self._variant_cycle)])
        kinds = (kinds * num_dims)[:len(dims)]
        sels = [self._star_sels[(i + k) % len(self._star_sels)]
                for k in range(len(dims))]
        self._qid += 1
        return make_star_query(
            _size(self.rng, 2 * self.base), [d.size for d in dims],
            selectivities=sels, seed=int(self.rng.integers(1 << 30)),
            aggregate=self._agg_cycle[i % len(self._agg_cycle)],
            dim_tables=dims, join_kinds=kinds, group_by=("F.g",))

    def _probe(self, keys: np.ndarray) -> Relation:
        """A probe relation of ``keys`` with arange rids, on the device."""
        n = keys.shape[0]
        return Relation(torch.arange(n, dtype=torch.int32,
                                     device=self.device),
                        torch.from_numpy(keys).to(self.device))

    def _query(self, b, s, tag, *, max_out) -> JoinQuery:
        self._qid += 1
        return JoinQuery(build=b, probe=s, tag=tag, max_out=max_out,
                         query_id=self._qid)

    # -- mixes --------------------------------------------------------------
    def stream(self, num_queries: int, mix="mixed") -> list[JoinQuery]:
        spec = MIXES[mix] if isinstance(mix, str) else tuple(mix)
        names = [n for n, _ in spec]
        w = np.array([float(x) for _, x in spec])
        w = w / w.sum()
        return [getattr(self, names[int(self.rng.choice(len(names), p=w))])()
                for _ in range(num_queries)]


def make_workload(mix: str = "mixed", num_queries: int = 32, *,
                  base_tuples: int = 65536, seed: int = 0,
                  **kw) -> list[JoinQuery]:
    """One-call workload: a seeded list of queries from a named mix."""
    return WorkloadGenerator(base_tuples, seed=seed, **kw).stream(
        num_queries, mix)


# -- open-loop traffic simulation -------------------------------------------
@dataclasses.dataclass
class TrafficEvent:
    """One arrival of the open-loop schedule: submit ``query`` at
    ``at_s`` (seconds from stream start) on behalf of ``tenant``."""

    at_s: float
    tenant: str
    query: JoinQuery


def open_loop(num_queries: int, *, rate_qps: float = 20.0,
              tenant_mix=(("default", 1.0),), mix="mixed",
              arrivals: str = "poisson", burst_factor: float = 8.0,
              burst_fraction: float = 0.25, hot_tenant: str | None = None,
              hot_skew: float = 0.0, deadlines: dict | None = None,
              base_tuples: int = 65536, seed: int = 0,
              **gen_kw) -> list[TrafficEvent]:
    """Build an open-loop arrival schedule (arrivals don't wait on
    completions — the load that makes admission control earn its keep).

    ``arrivals="poisson"`` draws i.i.d. exponential gaps at ``rate_qps``;
    ``"burst"`` is an on/off process: a ``burst_fraction`` of the timeline
    runs at ``burst_factor``× the base rate (the overload the shed path is
    for), the rest at the base rate.  ``tenant_mix`` weights tenant names;
    ``hot_tenant``/``hot_skew`` shift extra probability mass (``hot_skew``
    in [0, 1)) onto one tenant on top of its mix weight.  ``deadlines``
    maps tenant name → relative deadline seconds stamped on each query
    (tenants absent from the map submit best-effort queries).

    The schedule is deterministic in ``seed`` — the same events can be
    replayed against different admission modes for a fair comparison.
    """
    rng = np.random.default_rng(seed)
    gen = WorkloadGenerator(base_tuples, seed=seed + 1, **gen_kw)
    queries = gen.stream(num_queries, mix)

    names = [n for n, _ in tenant_mix]
    w = np.array([float(x) for _, x in tenant_mix], dtype=np.float64)
    w = w / w.sum()
    if hot_tenant is not None and hot_skew > 0.0:
        if hot_tenant not in names:
            names.append(hot_tenant)
            w = np.append(w, 0.0)
        w = w * (1.0 - hot_skew)
        w[names.index(hot_tenant)] += hot_skew

    base_gap = 1.0 / max(rate_qps, 1e-9)
    events: list[TrafficEvent] = []
    t = 0.0
    for q in queries:
        if arrivals == "poisson":
            t += float(rng.exponential(base_gap))
        elif arrivals == "burst":
            in_burst = rng.random() < burst_fraction
            gap = base_gap / (burst_factor if in_burst else 1.0)
            t += float(rng.exponential(gap))
        elif arrivals == "uniform":
            t += base_gap
        else:
            raise ValueError(f"unknown arrival process {arrivals!r}")
        tenant = names[int(rng.choice(len(names), p=w))]
        q.tenant = tenant
        if deadlines and tenant in deadlines:
            q.deadline_s = float(deadlines[tenant])
        events.append(TrafficEvent(t, tenant, q))
    return events
