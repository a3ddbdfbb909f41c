"""What a run keeps of each query it served, and what its readers read.

A ``Stage`` is one execution through ``JoinQueryService`` (a PHJ cell's
query, or one stage or the group-by sink of a pipeline), copied out of
its ``QueryOutcome`` so that the outcome, and the answer on the card it
holds, can be freed at once.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Stage:
    algorithm: str
    scheme: str
    schedule: tuple | None
    partition_ratio: float
    join_ratio: float
    build_layout_hit: bool
    probe_layout_hit: bool
    queued_s: float
    wall_s: float
    phase_s: dict
    build_n: int | None = None
    probe_n: int | None = None

    @classmethod
    def of(cls, outcome, build_n=None, probe_n=None) -> "Stage":
        plan = outcome.plan
        return cls(plan.algorithm, plan.scheme,
                   tuple(plan.schedule) if plan.schedule else None,
                   float(plan.partition_ratio), float(plan.join_ratio),
                   bool(outcome.partition_cache_hit),
                   bool(outcome.probe_partition_cache_hit),
                   float(outcome.queued_s), float(outcome.wall_s),
                   dict(outcome.timing.phase_s), build_n, probe_n)


@dataclasses.dataclass
class Query:
    """One client query: submitted, answered (or failed), on the host's
    ``perf_counter`` clock, with the base-table rows it read."""
    t_submit: float
    t_done: float
    rows: int
    stages: list = dataclasses.field(default_factory=list)
    spans: dict = dataclasses.field(default_factory=dict)  # bench spans
    error: str | None = None
    kind: str = ""               # the traffic's name for the query
    plan: str = ""               # what ran, for the run's log

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


@dataclasses.dataclass
class Readings:
    """Everything a per-layer reader may read about the window."""
    queries: list            # completed ``Query`` records
    spans: list              # the program's tracer spans of the window
    ledger: dict             # host-boundary bytes by cause, window delta
    cache: dict              # table-cache counters, window delta
    launches: dict           # kernel launch counters, window delta
    device: object = None    # ``DeviceTrace`` of the window
