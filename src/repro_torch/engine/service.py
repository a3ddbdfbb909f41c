"""Concurrent join-query service over one shared ``CoProcessor``.

The repo's benchmark scripts run one hand-configured join at a time; the
paper's headline — keep *both* processor groups busy and reuse resident
state — only pays off under a stream of queries.  ``JoinQueryService``
provides that layer:

  * **admission** — a bounded, tenant-aware two-level queue
    (``TenantFairQueue``: weighted fair share across tenants, EDF within
    one); ``submit`` enqueues (blocking or not), worker threads drain it.
    The C group runs on host threads and CUDA launches are asynchronous,
    so while one worker's C-group work runs on the host CPU another
    worker's G-group kernels from a *different* query run on the card.
  * **SLO enforcement** — a query with a deadline is priced at admission
    (``AdmissionController``): predicted completion past the deadline
    first *degrades* the query to the planner's cheapest plan, and if
    even that misses, *sheds* it with a structured ``Backpressure`` error
    carrying a retry-after hint (never a silent timeout).
  * **load-aware planning** — each query is planned by ``QueryPlanner``
    (cost-model scheme + algorithm choice) given the outstanding estimated
    seconds per group, so near-tie plans land on the idler group.
  * **build-table cache** — before planning, the build relation is
    fingerprinted against ``BuildTableCache``; a hit skips the build phase
    entirely (probe-only SHJ), a miss on a previously-seen fingerprint
    biases planning toward SHJ so the table becomes cacheable.
  * **feedback** — measured phase timings flow back into the planner's
    online unit-cost scales after every query.

Counterpart of ``repro/engine/service.py`` over the port's
``CoProcessor`` (C group on the host CPU, G group on the card).  Every
clock the service reads around device work stops after the groups'
``synchronize``: a CUDA launch returns before the card has run it, and a
time read earlier would feed launch latency to the planner.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np
import torch

from ..core.coprocess import CoProcessor, Timing
from ..core.hash_table import JoinResult, default_num_buckets
from ..obs import (CardinalityAudit, CostAudit, DriftDetector,
                       FlightRecorder, MetricsRegistry, NULL_TRACER,
                       SLOMonitor, Tracer, TransferLedger)

from .admission import (AdmissionController, Backpressure, QueueFull,
                        Tenant, TenantFairQueue)
from .faults import (FaultInjected, active as _faults_active,
                     layout_checksum, maybe_corrupt, maybe_fault)
from .planner import QueryPlan, QueryPlanner
from .resilience import (BreakerBoard, BudgetEnforcer, BudgetExceeded,
                         DeadlineExceeded, QueryContext, RetryPolicy)
from .table_cache import (BuildTableCache, partition_layout_key,
                          relation_fingerprint)


@dataclasses.dataclass
class JoinQuery:
    """One join request: build (R) and probe (S) relations plus limits."""

    build: object                 # Relation
    probe: object                 # Relation
    tag: str = "adhoc"
    max_out: int | None = None    # result capacity; defaulted from |S|
    query_id: int = -1
    priority: int = 0             # higher runs earlier (aged, so no starving)
    # Join-variant semantics: "inner" | "semi" | "anti" | "left_outer".
    # Non-inner kinds probe the same (cacheable) build table but emit
    # match flags / unmatched rows instead of the full expansion.
    kind: str = "inner"
    # Multi-tenant SLO fields: ``tenant`` names the workload container the
    # query is billed to; ``deadline_s`` is a relative deadline stamped
    # into the absolute ``deadline_at`` at admission (a tenant's default
    # deadline class applies when neither is set).  ``degraded`` marks a
    # query admission re-priced onto the planner's cheapest plan.
    tenant: str = "default"
    deadline_s: float | None = None
    deadline_at: float | None = None
    degraded: bool = False


@dataclasses.dataclass
class GroupByQuery:
    """One group-by aggregation request (the ops subsystem's operator).

    ``keys.rid`` must index rows of ``values`` (the arange gather
    convention); the service plans it like a join (scheme choice, group
    locks, calibration feedback) and runs ``CoProcessor.groupby``.
    """

    keys: object                  # Relation: key = group key, rid = row id
    values: object                # (n,) int32 value column (host or device)
    tag: str = "groupby"
    query_id: int = -1
    priority: int = 0
    # Legacy int32-wrapping sum accumulator (oracle-parity tests); the
    # default accumulates wide (exact int64 sums).
    wrap32: bool = False
    # Multi-tenant SLO fields (see JoinQuery).
    tenant: str = "default"
    deadline_s: float | None = None
    deadline_at: float | None = None
    degraded: bool = False


@dataclasses.dataclass
class QueryOutcome:
    query_id: int
    tag: str
    plan: QueryPlan
    timing: Timing
    cache_hit: bool
    queued_s: float
    wall_s: float                 # plan + execute (excludes queue wait)
    result: object                # JoinResult | GroupByResult
    partition_cache_hit: bool = False
    priority: int = 0
    probe_partition_cache_hit: bool = False
    # SLO bookkeeping: the billed tenant, whether admission degraded the
    # plan, the inherited absolute deadline (None = best-effort), and
    # whether execution finished inside it (None when no deadline).
    tenant: str = "default"
    degraded: bool = False
    deadline_at: float | None = None
    deadline_hit: bool | None = None
    # Host-boundary bytes the *caller* moved to hand this query its inputs
    # and consume its outputs (H2D + D2H for query intermediates).  The
    # query-pipeline executor fills this in per stage: ~0 on the fused
    # device-resident path, the full gather/re-upload volume on the
    # host-materialize path.  Engine-internal movement (group splits,
    # concats) is tracked separately by Timing.transfer_bytes.
    host_bytes_moved: int = 0
    # Structured per-query trace: the span dicts recorded for this
    # execution (admit -> queue -> plan -> phases), in completion order.
    # None when the service's tracer is disabled.  Deliberately excluded
    # from to_dict() — bench rollups aggregate thousands of outcomes and
    # the Chrome-trace artifact already carries the spans.
    trace: list | None = None

    def to_dict(self) -> dict:
        """Everything a bench rollup needs to segment latency by plan type
        — algorithm/scheme/kind, the cache-hit flags, and the PHJ schedule
        — without re-deriving any of it from the plan object."""
        matches = (int(self.result.count)
                   if isinstance(self.result, JoinResult)
                   else int(self.result.num_groups))
        return {"query_id": self.query_id, "tag": self.tag,
                "priority": self.priority,
                "tenant": self.tenant, "degraded": self.degraded,
                "deadline_hit": self.deadline_hit,
                "algorithm": self.plan.algorithm,
                "scheme": self.plan.scheme,
                "kind": self.plan.kind,
                "table_mode": self.plan.table_mode,
                "cache_hit": self.cache_hit,
                "partition_cache_hit": self.partition_cache_hit,
                "probe_partition_cache_hit": self.probe_partition_cache_hit,
                "schedule": (list(self.plan.schedule)
                             if self.plan.schedule else None),
                "est_s": self.plan.est_s,
                "queued_s": self.queued_s, "wall_s": self.wall_s,
                "matches": matches,
                "host_bytes_moved": int(self.host_bytes_moved),
                "timing": self.timing.to_dict()}


class PriorityAgingQueue:
    """Bounded priority queue: highest priority first, FIFO within a level.

    Waiting items age — effective priority is ``priority + waited/aging_s``
    — so a steady stream of high-priority queries cannot starve a low-
    priority one: after ``aging_s * gap`` seconds the old query outranks
    every fresh arrival.  ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, maxsize: int = 0, *, aging_s: float = 5.0,
                 clock=time.monotonic):
        self.maxsize = int(maxsize)
        self.aging_s = float(aging_s)
        self._clock = clock
        self._items: list[tuple[int, int, float, object]] = []
        self._cond = threading.Condition()
        self._seq = 0

    def __len__(self) -> int:
        with self._cond:
            return len(self._items)

    qsize = __len__

    def put(self, item, priority: int = 0, block: bool = True,
            timeout: float | None = None):
        with self._cond:
            if self.maxsize > 0:
                if not block and len(self._items) >= self.maxsize:
                    raise queue.Full
                end = None if timeout is None else self._clock() + timeout
                while len(self._items) >= self.maxsize:
                    rem = None if end is None else end - self._clock()
                    if rem is not None and rem <= 0:
                        raise queue.Full
                    if not self._cond.wait(rem):
                        raise queue.Full
            self._seq += 1
            self._items.append((int(priority), self._seq, self._clock(),
                                item))
            self._cond.notify()

    def _pop_best(self):
        now = self._clock()

        def eff(entry):
            prio, seq, enq_t, _ = entry
            # Tie-break on -seq: among equal effective priorities the
            # oldest admission wins (FIFO within a level).
            return (prio + (now - enq_t) / self.aging_s, -seq)

        i = max(range(len(self._items)), key=lambda j: eff(self._items[j]))
        entry = self._items.pop(i)
        self._cond.notify()          # a blocked put may now have room
        return entry[3]

    def get(self, timeout: float | None = None):
        with self._cond:
            end = None if timeout is None else self._clock() + timeout
            while not self._items:
                rem = None if end is None else end - self._clock()
                if rem is not None and rem <= 0:
                    raise queue.Empty
                if not self._cond.wait(rem):
                    raise queue.Empty
            return self._pop_best()

    def get_nowait(self):
        with self._cond:
            if not self._items:
                raise queue.Empty
            return self._pop_best()

    def task_done(self):              # queue.Queue API compat (no join())
        pass


def _plan_groups(plan: QueryPlan) -> set[str]:
    """Which device groups a plan's execution can touch.

    Conservative: any CPU-side share > 0 uses C, any share < 1 uses G;
    split phases additionally merge/concat on C.
    """
    if plan.algorithm in ("phj", "groupby"):
        rats = [plan.partition_ratio, plan.join_ratio]
    else:
        rats = list(plan.probe_ratios)
        if not plan.cached:
            rats += list(plan.build_ratios)
    used = set()
    if any(r > 0.0 for r in rats):
        used.add("C")
    if any(r < 1.0 for r in rats):
        used.add("G")
    if any(0.0 < r < 1.0 for r in rats):
        used.add("C")               # merge/concat runs on the C-group
    return used or {"C"}


class JoinQueryService:
    """Plans and executes a stream of join queries on shared groups."""

    def __init__(self, cp: CoProcessor | None = None,
                 planner: QueryPlanner | None = None, *,
                 cache_budget_bytes: int = 256 << 20,
                 tenant_cache_budget_bytes=None,
                 max_queue: int = 128, num_workers: int = 2,
                 priority_aging_s: float = 5.0,
                 tenants=None, admission_mode: str = "cost",
                 max_deferred: int | None = None,
                 clock=time.monotonic,
                 tracer: Tracer | None = None,
                 metrics: MetricsRegistry | None = None,
                 flight: FlightRecorder | None = None,
                 slo: SLOMonitor | None = None,
                 drift: DriftDetector | None = None,
                 preempt: bool = False,
                 enforce_budgets: bool = False,
                 retry: RetryPolicy | None = None,
                 breakers: BreakerBoard | None = None,
                 budget: BudgetEnforcer | None = None):
        self.cp = cp or CoProcessor()
        self.planner = planner or QueryPlanner()
        self.cache = BuildTableCache(
            cache_budget_bytes, tenant_budget_bytes=tenant_cache_budget_bytes)
        self.num_workers = int(num_workers)
        self._clock = clock
        # Observability: spans (query lifecycle), a metrics registry (all
        # service counters live there — one lock, one coherent snapshot),
        # and the predicted-vs-measured cost-model audit trail.  Pass
        # ``tracer=NULL_TRACER`` to run with tracing disabled.
        self.tracer = tracer if tracer is not None else Tracer()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.audit = CostAudit()
        # Data-path observability: every host-boundary byte is attributed
        # to (stage, column, cause) in the transfer ledger — the flat
        # ``host_bytes_moved`` counter is the ledger's intermediate-cause
        # sum view — and every executed stage's (estimated, observed)
        # cardinality pair lands in the cardinality audit.
        self.ledger = TransferLedger(self.metrics)
        self.cardinality = CardinalityAudit()
        # A CoProcessor constructed standalone carries the no-op tracer;
        # adopt it into this service's tracer so its phase spans land in
        # the query lifecycle.  An explicitly-traced CoProcessor is left
        # alone.
        if getattr(self.cp, "tracer", None) is NULL_TRACER:
            self.cp.tracer = self.tracer
        # Deadline-aware multi-tenant admission: the controller prices
        # admit/degrade/shed decisions from planner estimates; the queue
        # serves tenants weighted-fair, EDF within each.  ``fifo`` mode is
        # the count-only baseline slo_bench measures against.
        self.admission = AdmissionController(
            tenants, num_workers=max(1, self.num_workers),
            mode=admission_mode)
        self._queue = TenantFairQueue(
            maxsize=max_queue, aging_s=priority_aging_s, clock=clock,
            weight_fn=self.admission.weight_of,
            fifo=(admission_mode == "fifo"))
        # Deferred (pipeline-stage) submissions are bounded too: each
        # pending stage holds one slot, so a deep or wide pipeline blocks
        # (or bounces, block=False) instead of spawning unbounded threads.
        self._deferred_sem = threading.BoundedSemaphore(
            max_deferred if max_deferred is not None
            else max(1, int(max_queue) or 128))
        self._workers: list[threading.Thread] = []
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._loads = {"C": 0.0, "G": 0.0}
        self._seen_fingerprints: set[str] = set()
        self._observed_sigs: set[tuple] = set()
        self._inflight = 0
        self._exec_epoch = 0
        # Fingerprint memo keyed by array identity: hot-table traffic
        # re-submits the same Relation objects, and re-hashing 8 bytes per
        # tuple on every repeat would tax exactly the queries the cache
        # makes cheap.  Held references keep the ids stable; bounded FIFO.
        self._fp_cache: dict = {}
        # Service counters live in the metrics registry (per-tenant
        # labeled series; ``stats()`` reads them back in one snapshot).
        # Point-in-time views of components are registered as collectors
        # so the same snapshot carries queue depth, cache and planner
        # state, calibration version ticks and the audit summary.
        self.cache.register_metrics(self.metrics)
        self.metrics.register_collector("queue_depth",
                                        lambda: len(self._queue))
        self.metrics.register_collector("planner", self.planner.stats)
        self.metrics.register_collector(
            "calibration_version", lambda: int(self.planner.online.version))
        self.metrics.register_collector("prediction_error",
                                        self.audit.summary)
        self.metrics.register_collector("cardinality_error",
                                        self.cardinality.summary)
        self.metrics.register_collector("host_transfer_ledger",
                                        self.ledger.summary)
        # The closed loop: a flight recorder of recent lifecycles (dumps
        # itself on failures / shed storms / miss bursts), an SLO burn-
        # rate monitor over the per-tenant counters, and a drift detector
        # on the audit trail that flags stale sticky plans for re-pricing
        # and feeds per-tenant safety margins back into admission.  All
        # on by default; each is a bounded ring plus O(1) updates.
        self.flight = flight if flight is not None else \
            FlightRecorder(clock=clock)
        self.slo = slo if slo is not None else \
            SLOMonitor(self.metrics, clock=clock, tracer=self.tracer)
        self.drift = drift if drift is not None else DriftDetector(
            metrics=self.metrics, tracer=self.tracer,
            on_drift=self._on_drift, on_margin=self.admission.set_margin,
            clock=clock)
        self.audit.add_listener(self.drift.observe_record)
        self.metrics.register_collector("flight", self.flight.summary)
        self.metrics.register_collector("slo", self.slo.summary)
        self.metrics.register_collector("drift", self.drift.summary)
        self.metrics.set_gauge("audit_capacity",
                               float(self.audit.capacity))
        # Pre-seed so snapshot()["host_bytes_moved"] is always present —
        # the fused data path's whole point is to never increment it.
        self.metrics.inc("host_bytes_moved", 0)
        # Resilience layer (see ``engine.resilience``): cooperative
        # deadline preemption (``preempt=True`` threads a QueryContext
        # into the kernels, checked at pass boundaries), runtime C/G
        # budget enforcement off the measured-cost audit stream
        # (``enforce_budgets=True``), and the recovery ladder — bounded
        # retries for transient faults, one degraded retry, per-
        # (algorithm, scheme) circuit breakers quarantining a failing
        # kernel variant to the NumPy reference path.  All off by
        # default: the defaults keep every execution byte-identical to
        # the pre-resilience service.
        self.preempt = bool(preempt)
        self.retry = retry if retry is not None else RetryPolicy()
        self.breakers = breakers if breakers is not None else BreakerBoard(
            clock=clock, metrics=self.metrics, flight=self.flight)
        self.budget = budget
        if enforce_budgets and self.budget is None:
            self.budget = BudgetEnforcer(self.admission, clock=clock,
                                         metrics=self.metrics)
        if self.budget is not None:
            self.audit.add_listener(self.budget.on_record)
            self.metrics.register_collector("budget", self.budget.summary)
        self.metrics.register_collector("breakers", self.breakers.summary)
        self._closing = False
        self._busy_workers = 0
        # Injector-era layout checksums (content sums stored at cache-
        # insert time, validated at reuse); empty — and never consulted —
        # when no fault injector is installed.
        self._layout_sums: dict = {}
        for name in self._RESILIENCE_COUNTERS:
            self.metrics.inc(name, 0)

    # Per-tenant counter names mirrored into the registry (and the exact
    # key set ``stats()["tenants"][t]`` has always exposed).
    _TENANT_COUNTERS = ("admitted", "rejected", "shed", "degraded",
                        "completed", "deadline_hits", "deadline_misses")

    # Resilience counters pre-seeded at construction so ``stats()`` and
    # bench payloads always carry them (zero = nothing happened, absent =
    # nothing measured).
    _RESILIENCE_COUNTERS = (
        "preemptions", "budget_throttles", "retries", "worker_restarts",
        "checkpoints", "partition_resumes", "breaker_short_circuits",
        "cache_validation_failures", "cache_insert_failures",
        "cancelled_on_close")

    def _count(self, name: str, tenant: str | None = None) -> None:
        """Bump a service counter (and its per-tenant series).

        Never called under ``self._lock`` — the registry lock is a leaf
        lock (see ``MetricsRegistry``), which is what makes ``stats()``
        one coherent pass instead of the old counters-then-components
        split."""
        if tenant is None:
            self.metrics.inc(name)
        else:
            self.metrics.inc(name, tenant=tenant)

    def _admission_event(self, action: str, bp: Backpressure) -> None:
        """Persist one shed/reject decision: bump its counter and emit a
        structured event (reason, predicted_s, deadline_s,
        retry_after_s) into the registry plus an instant into the trace,
        so consumers read admission decisions from metrics instead of
        re-deriving them from raised ``Backpressure`` exceptions."""
        self._count("shed" if action == "shed" else "rejected", bp.tenant)
        self.metrics.event("admission", action=action, **bp.to_dict())
        self.tracer.instant(action, tenant=bp.tenant,
                            query_id=bp.query_id, reason=bp.reason)
        self.flight.record_admission(action, **bp.to_dict())
        self.slo.evaluate()

    # Which algorithm's sticky plans a drifted audit phase invalidates
    # ("partition" is shared by phj and groupby — match any algorithm).
    _DRIFT_ALGO = {"build": "shj", "probe": "shj", "join": "phj",
                   "agg": "groupby", "partition": None}

    def _on_drift(self, phase: str, scheme: str, stats: dict) -> None:
        """Sustained cost-model drift on (phase, scheme): flag the
        affected sticky plans for re-pricing through the planner's
        existing replan-hysteresis path."""
        flagged = self.planner.flag_replan(
            algorithm=self._DRIFT_ALGO.get(phase), scheme=scheme)
        if flagged:
            self.metrics.inc("plans_flagged_for_replan", flagged)

    # Read-only counter views (the attribute API the service always had).
    def _counter_total(self, name: str) -> int:
        return int(self.metrics.counter_value(name))

    admitted = property(lambda self: self._counter_total("admitted"))
    rejected = property(lambda self: self._counter_total("rejected"))
    completed = property(lambda self: self._counter_total("completed"))
    failed = property(lambda self: self._counter_total("failed"))
    shed = property(lambda self: self._counter_total("shed"))
    degraded = property(lambda self: self._counter_total("degraded"))
    host_bytes_moved = property(
        lambda self: self._counter_total("host_bytes_moved"))

    def note_host_bytes(self, nbytes: int, *, cause: str = "handoff",
                        stage: str = "-", column: str = "-",
                        direction: str = "d2h",
                        tenant: str = "default") -> None:
        """Attribute caller-side host-boundary traffic through the ledger.

        The ledger increments ``host_bytes_moved`` for every intermediate
        cause (``result`` bytes are attributed but excluded — final result
        delivery was never counted as intermediate traffic), so the flat
        counter stays a sum view over the ledger.
        """
        self.ledger.record(nbytes, cause=cause, stage=stage, column=column,
                           direction=direction, tenant=tenant)

    def _fingerprint(self, rel, num_buckets: int, *,
                     stage: str = "-", column: str = "key",
                     tenant: str = "default") -> str:
        # Structural fast path: a relation carrying an fp_hint (every
        # pipeline-built stage input does) is keyed without touching the
        # array contents — no D2H pull, nothing for the ledger.
        hint = getattr(rel, "fp_hint", None)
        if hint:
            return f"struct:{hint}|b={num_buckets}"
        memo_key = (id(rel.rid), id(rel.key), num_buckets)
        with self._lock:
            hit = self._fp_cache.get(memo_key)
            if hit is not None:
                return hit[0]
        # Content hash of a hint-less relation: for device-resident arrays
        # this pulls both columns across the boundary — attributed under
        # the ledger's ``fingerprint`` cause (memo-missed pulls only; a
        # repeat of the same array objects hits the memo above).
        pulled = sum(int(getattr(col, "nbytes", 0))
                     for col in (rel.rid, rel.key)
                     if not isinstance(col, np.ndarray))
        fp = relation_fingerprint(rel, num_buckets)
        if pulled:
            self.ledger.record(pulled, cause="fingerprint", stage=stage,
                               column=column, direction="d2h",
                               tenant=tenant)
        with self._lock:
            if len(self._fp_cache) > 256:
                self._fp_cache.clear()
            self._fp_cache[memo_key] = (fp, rel.rid, rel.key)
        return fp

    def _device_wall(self, t0: float) -> float:
        """Seconds since the ``perf_counter`` stamp ``t0``, read once the
        groups' device work has finished (a CUDA launch returns before the
        card runs it)."""
        self.cp.synchronize()
        return time.perf_counter() - t0

    # -- synchronous execution path (also what workers run) -----------------
    def _make_ctx(self, q) -> QueryContext | None:
        """The query's cooperative control block — None when neither
        preemption nor budget enforcement is on (the kernels then take
        their exact pre-resilience fused paths)."""
        if not self.preempt and self.budget is None:
            return None
        return QueryContext(
            query_id=q.query_id, tenant=q.tenant,
            deadline_at=(q.deadline_at if self.preempt else None),
            clock=self._clock, enforcer=self.budget,
            on_throttle=self._on_throttle)

    def _on_throttle(self, tenant: str, delay_s: float) -> None:
        self.metrics.inc("budget_throttles", tenant=tenant)
        self.tracer.instant("budget_throttle", tenant=tenant)

    def _note_preempt(self, e: Backpressure, where: str = "") -> None:
        """Account one mid-flight preemption (deadline / budget / cancel)
        exactly once — a structured service decision, not a failure."""
        if getattr(e, "_svc_preempt_counted", False):
            return
        e._svc_preempt_counted = True
        cause = getattr(e, "reason", "backpressure")
        self.metrics.inc("preemptions", tenant=e.tenant, cause=cause)
        self.metrics.event("preempt", cause=cause, tenant=e.tenant,
                           query_id=e.query_id, where=where)
        self.tracer.instant("preempt", tenant=e.tenant,
                            query_id=e.query_id, reason=cause)
        self.flight.record_resilience("preempt", cause=cause,
                                      tenant=e.tenant,
                                      query_id=e.query_id, where=where)

    def execute(self, q, *, enqueued_at: float | None = None
                ) -> QueryOutcome:
        """Run one query now.  ``enqueued_at`` (a ``perf_counter`` stamp)
        is how queue wait reaches the outcome's ``queued_s`` — the direct
        path has no queue, so it reports 0.0 honestly."""
        queued_s = (0.0 if enqueued_at is None
                    else max(0.0, time.perf_counter() - enqueued_at))
        # Direct executions bypass submit(): stamp the deadline here so
        # the outcome's verdict (and deferred inheritance) still work.
        self._stamp_deadline(q, self._clock())
        ctx = self._make_ctx(q)
        try:
            if ctx is not None:
                # A query whose deadline already passed while queued is
                # dropped here in O(1) — the biggest capacity saver under
                # overload: no device seconds burned on a guaranteed miss.
                ctx.check("pre_execute")
            if isinstance(q, GroupByQuery):
                return self._execute_groupby(q, queued_s, ctx)
            return self._execute_join(q, queued_s, ctx)
        except Backpressure as e:
            self._note_preempt(e, where="execute")
            raise

    def _obs_begin(self, q):
        """Allocate the query's trace correlation key (``q_key``) and
        retro-record its queue-wait lane span (``_obs_enq`` was stamped
        at submit on the tracer clock; queue wait starts on the caller's
        thread and ends on a worker's, so it cannot nest on either
        thread's stack — it becomes an async lane interval)."""
        tr = self.tracer
        if not tr.enabled:
            return None
        key = getattr(q, "_obs_key", None)
        if key is None:
            key = q._obs_key = tr.next_key()
        enq = getattr(q, "_obs_enq", None)
        if enq is not None:
            q._obs_enq = None
            tr.lane("queue", enq, tr.now(), q_key=key,
                    query_id=q.query_id, tenant=q.tenant, tag=q.tag)
        return key

    def _finish_outcome(self, q) -> bool | None:
        """Completion bookkeeping: totals, per-tenant counts, deadline
        verdict (measured on the service clock the deadline was stamped
        with)."""
        deadline_hit = None
        if q.deadline_at is not None:
            deadline_hit = bool(self._clock() <= q.deadline_at)
        self._count("completed", q.tenant)
        if deadline_hit is True:
            self._count("deadline_hits", q.tenant)
        elif deadline_hit is False:
            self._count("deadline_misses", q.tenant)
        self.slo.evaluate()
        return deadline_hit

    def _execute_join(self, q: JoinQuery, queued_s: float = 0.0,
                      ctx: QueryContext | None = None) -> QueryOutcome:
        obs_key = self._obs_begin(q)
        with self.tracer.span("query", q_key=obs_key, query_id=q.query_id,
                              tenant=q.tenant, tag=q.tag,
                              kind=q.kind) as qspan:
            result, plan, timing, flags = self._run_join(q, qspan, ctx)
        # Audit EVERY executed plan (phase, scheme, est_s, measured_s):
        # calibration's warm/solo gating filters out contended samples,
        # but measuring how wrong the solo-time estimate was *under
        # contention* is exactly the audit's job.
        self.audit.record(self.planner.phase_pairs(plan, timing),
                          tenant=q.tenant, query_id=q.query_id)
        deadline_hit = self._finish_outcome(q)
        cache_hit, partition_hit, probe_partition_hit, wall = flags
        outcome = QueryOutcome(q.query_id, q.tag, plan, timing, cache_hit,
                               queued_s, wall, result,
                               partition_cache_hit=partition_hit,
                               probe_partition_cache_hit=probe_partition_hit,
                               priority=q.priority, tenant=q.tenant,
                               degraded=q.degraded,
                               deadline_at=q.deadline_at,
                               deadline_hit=deadline_hit)
        if obs_key is not None:
            outcome.trace = self.tracer.spans_for(obs_key)
        self.metrics.observe("query_latency_s", queued_s + wall,
                             tenant=q.tenant)
        self.flight.record_outcome(outcome)
        return outcome

    # -- resilience plumbing -------------------------------------------------
    def _peek_layout(self, layout_key):
        """Partition-layout cache peek with injector-era validation: when
        a fault injector is live, a stored layout whose content checksum
        no longer matches the one recorded at insert (a ``corrupt``-mode
        fault) is treated as a miss — corruption must surface as a cache
        miss, never as a wrong join result.  Checksums cost a D2H pull,
        so none of this runs in normal serving."""
        rel = self.cache.peek_partition(layout_key)
        if rel is None or not _faults_active():
            return rel
        expect = self._layout_sums.get(layout_key)
        if expect is not None and layout_checksum(rel) != expect:
            self.metrics.inc("cache_validation_failures")
            self.flight.record_resilience("cache_corruption",
                                          key=str(layout_key)[:120])
            return None
        return rel

    def _put_layout(self, putter, layout_key, rel, tenant: str) -> None:
        """Cache insert through the ``cache_insert`` fault site.  A raise-
        mode fault skips the insert (a failed cache write must never fail
        the query that computed the layout); a corrupt-mode fault stores
        a flipped layout whose checksum — taken from the *clean* relation
        — exposes it at the next peek."""
        if not _faults_active():
            putter(layout_key, rel, tenant)
            return
        clean_sum = layout_checksum(rel)
        try:
            maybe_fault("cache_insert")
        except FaultInjected as e:
            self.metrics.inc("cache_insert_failures")
            self.flight.record_resilience("cache_insert_failed",
                                          error=repr(e)[:120])
            return
        self._layout_sums[layout_key] = clean_sum
        putter(layout_key, maybe_corrupt("cache_insert", rel), tenant)

    def _store_checkpoints(self, q, ctx: QueryContext, plan) -> None:
        """Persist a preempted query's partial partition layouts under
        their completed-pass schedule-prefix keys, so a re-admitted run
        resumes at ``start_pass = k`` instead of restarting."""
        sched = tuple(plan.schedule or ())
        for tag, (rel, k) in list(ctx.partials.items()):
            base = ctx.meta.get("pkey_base" if tag == "R" else "skey_base")
            if base is None or not 0 < k < len(sched):
                continue
            prefix = sched[:k]
            if tag == "R":
                pk = partition_layout_key(base, prefix)
                self._put_layout(self.cache.put_partition, pk, rel,
                                 q.tenant)
            else:
                pk = partition_layout_key(base, prefix, side="S")
                self._put_layout(self.cache.put_probe_partition, pk, rel,
                                 q.tenant)
            self.metrics.inc("checkpoints", tenant=q.tenant)
            self.flight.record_resilience(
                "checkpoint", tag=tag, passes_done=k,
                schedule=list(sched), query_id=q.query_id,
                tenant=q.tenant)

    def _resume_probe(self, base_fp: str, schedule, side: str = "R"):
        """Longest-first probe of schedule-prefix checkpoint keys.
        Returns ``(partial layout, completed passes)`` or ``(None, None)``."""
        from ..core.phj import schedule_prefixes
        if not self.preempt or not schedule:
            return None, None
        for prefix in schedule_prefixes(schedule):
            pk = (partition_layout_key(base_fp, prefix) if side == "R"
                  else partition_layout_key(base_fp, prefix, side="S"))
            cand = self._peek_layout(pk)
            if cand is not None:
                return cand, len(prefix)
        return None, None

    def _run_join(self, q: JoinQuery, qspan=None,
                  ctx: QueryContext | None = None):
        """Plan + execute one join (the body of ``_execute_join``, run
        inside its query span).  Returns ``(result, plan, timing,
        (cache_hit, partition_hit, probe_partition_hit, wall_s))``."""
        t0 = time.perf_counter()
        build_n, probe_n = q.build.size, q.probe.size
        # ``is None`` (not falsy) — an explicit max_out=0 is a legitimate
        # capacity for expected-empty probes and must not be replaced by
        # the heuristic default.
        max_out = (q.max_out if q.max_out is not None
                   else 4 * probe_n + 1024)
        nb = default_num_buckets(build_n)
        key = self._fingerprint(q.build, nb, stage=q.tag,
                                column="build.key", tenant=q.tenant)
        table = self.cache.peek(key)
        with self._lock:
            seen = key in self._seen_fingerprints
            self._seen_fingerprints.add(key)
            c_load, g_load = self._loads["C"], self._loads["G"]
        with self.tracer.span("plan"):
            if q.degraded:
                # Deadline-degraded: admission promised the cheapest plan.
                plan = self.planner.choose_degraded(
                    build_n, probe_n, max_out=max_out,
                    cached=table is not None, kind=q.kind)
            else:
                plan = self.planner.choose(
                    build_n, probe_n, max_out=max_out,
                    cached=table is not None,
                    expect_reuse=seen and table is None,
                    c_load=c_load, g_load=g_load, kind=q.kind)
        if qspan is not None:
            # Ambient for the phase spans opened below on this thread.
            qspan.set(algorithm=plan.algorithm, scheme=plan.scheme)
        # Circuit breaker: a quarantined (algorithm, scheme) variant runs
        # on the NumPy reference path — slower, but correct and immune to
        # whatever is killing the kernels.  HALF_OPEN lets one trial
        # through onto the real path.
        plan_key = (plan.algorithm, plan.scheme)
        if not self.breakers.allow(plan_key):
            self.metrics.inc("breaker_short_circuits", tenant=q.tenant)
            self.flight.record_resilience(
                "breaker_short_circuit", phase=plan.algorithm,
                scheme=plan.scheme, query_id=q.query_id, tenant=q.tenant)
            result = self._reference_join_result(q, max_out)
            timing = Timing(tracer=self.cp.tracer)
            timing.notes["reference_path"] = True
            wall = self._device_wall(t0)
            timing.phase_s["reference"] = wall
            timing.wall_s = wall
            return result, plan, timing, (False, False, False, wall)
        share = plan.c_share
        with self._lock:
            self._loads["C"] += plan.est_s * share
            self._loads["G"] += plan.est_s * (1.0 - share)
            self._inflight += 1
            inflight_at_start = self._inflight
            start_epoch = self._exec_epoch
            self._exec_epoch += 1
        # Execution is serialized per device group: two queries' G-group
        # work interleaved on the card's one stream would make each
        # query's synchronized phase times hold the other's kernels, and
        # two queries' C-group work would split the host's cores.
        # Disjoint plans — one C-only, one G-only — run concurrently,
        # which is the overlap the admission queue exists to create.
        # Fixed C-then-G acquisition order.
        held = [self.cp.group_locks[g] for g in ("C", "G")
                if g in _plan_groups(plan)]
        for lock in held:
            lock.acquire()
        partition_hit = False
        probe_partition_hit = False
        try:
            from ..ops.join_variants import probe_table_variant
            cache_hit = table is not None and plan.cached
            if cache_hit:
                self.cache.get(key, q.tenant)  # record the hit + LRU touch
                timing = Timing(tracer=self.cp.tracer)
                timing.phase_s["build"] = 0.0
                result, timing = probe_table_variant(
                    self.cp, q.probe, table, kind=q.kind, max_out=max_out,
                    ratios=plan.probe_ratios, timing=timing)
            elif plan.algorithm == "phj":
                # Partition-layout cache: a repeated PHJ build OR probe
                # side skips its n1–n3 passes off the resident partitioned
                # layout (keyed by content + schedule + side; hits counted
                # separately per side).
                pkey = partition_layout_key(key, plan.schedule)
                layout = self._peek_layout(pkey)
                # Probe layouts depend only on content + schedule — NOT on
                # the build table's bucket count — so the same probe
                # relation re-probed against differently-sized build
                # tables still hits (fingerprinted at num_buckets=0).
                probe_fp = self._fingerprint(q.probe, 0, stage=q.tag,
                                             column="probe.key",
                                             tenant=q.tenant)
                skey = partition_layout_key(probe_fp, plan.schedule,
                                            side="S")
                probe_layout = self._peek_layout(skey)
                # Checkpoint resume: a full-layout miss probes the
                # schedule-prefix keys a preempted run stored; a hit
                # resumes partitioning at its completed-pass count.
                build_resume = probe_resume = None
                if layout is None:
                    layout, build_resume = self._resume_probe(
                        key, plan.schedule)
                if probe_layout is None:
                    probe_layout, probe_resume = self._resume_probe(
                        probe_fp, plan.schedule, side="S")
                for tag, k in (("R", build_resume), ("S", probe_resume)):
                    if k is not None:
                        self.metrics.inc("partition_resumes",
                                         tenant=q.tenant)
                        self.flight.record_resilience(
                            "partition_resume", tag=tag, passes_done=k,
                            query_id=q.query_id, tenant=q.tenant)
                if ctx is not None:
                    ctx.meta.update(pkey_base=key, skey_base=probe_fp)
                parts_out: dict = {}
                result, timing = self.cp.phj(
                    q.build, q.probe, schedule=plan.schedule,
                    shj_bits=plan.shj_bits, max_out=max_out,
                    partition_ratio=plan.partition_ratio,
                    join_ratio=plan.join_ratio,
                    build_parts=layout, probe_parts=probe_layout,
                    parts_out=parts_out, ctx=ctx,
                    build_resume=build_resume, probe_resume=probe_resume)
                if layout is not None and build_resume is None:
                    self.cache.get_partition(pkey, q.tenant)  # hit + touch
                    partition_hit = True
                else:
                    self.cache.record_partition_miss(q.tenant)
                    self._put_layout(self.cache.put_partition, pkey,
                                     parts_out["R"], q.tenant)
                if probe_layout is not None and probe_resume is None:
                    self.cache.get_probe_partition(skey, q.tenant)
                    probe_partition_hit = True
                else:
                    self.cache.record_probe_partition_miss(q.tenant)
                    self._put_layout(self.cache.put_probe_partition, skey,
                                     parts_out["S"], q.tenant)
            else:
                # Miss accounting mirrors hit accounting: only a plan that
                # would have *used* a resident table counts as a miss (a
                # PHJ plan never wants one, in either direction).
                self.cache.record_miss(q.tenant)
                table, timing = self.cp.build_table(
                    q.build, num_buckets=plan.num_buckets,
                    ratios=plan.build_ratios, table_mode=plan.table_mode)
                result, timing = probe_table_variant(
                    self.cp, q.probe, table, kind=q.kind, max_out=max_out,
                    ratios=plan.probe_ratios, timing=timing)
                self.cache.put(key, table, q.tenant)
        except Backpressure:
            # Preempted mid-flight (deadline / budget / cancel): free a
            # half-open breaker trial without a verdict and checkpoint
            # any completed partition passes for the re-admitted run.
            self.breakers.release(plan_key)
            if ctx is not None and ctx.partials:
                self._store_checkpoints(q, ctx, plan)
            raise
        except Exception as e:
            # Tag the failing plan variant so the recovery ladder can
            # feed the breaker for this (algorithm, scheme).
            e._svc_plan_key = plan_key
            raise
        finally:
            for lock in reversed(held):
                lock.release()
            with self._lock:
                self._loads["C"] -= plan.est_s * share
                self._loads["G"] -= plan.est_s * (1.0 - share)
                self._inflight -= 1
                # Solo = nothing was running when we started and nothing
                # started while we ran: the measured time is free of
                # cross-query CPU contention.
                solo = (inflight_at_start == 1
                        and self._exec_epoch == start_epoch + 1)
        # Clean execution: reset the variant's consecutive-failure count
        # (and close a successful half-open trial).
        self.breakers.record_success(plan_key)
        # Feedback gates: (a) the first execution of an (algorithm, scheme,
        # shape) signature pays one-time costs (kernel builds, allocator
        # growth, first-touch of cached state); (b) a query
        # that overlapped another execution measured shared-core contention
        # on top of its own cost — one tainted sample can exile a scheme
        # for good (its scale only corrects when it runs again).  Only
        # warmed, solo samples calibrate the model.  (Ratios are
        # deliberately excluded from the signature: they come from the
        # unscaled sweep, so they are a function of it already.)
        # max_out is part of the signature: it sizes the result buffers,
        # so a different value allocates anew even at identical relation
        # shapes (kept as the reference keys it).
        sig = (plan.algorithm, plan.scheme, plan.cached, plan.kind,
               build_n, probe_n, max_out)
        with self._lock:
            warmed = sig in self._observed_sigs
            self._observed_sigs.add(sig)
        # A partition-cache hit (either side) skipped partition passes, so
        # its partition phase time is not a clean sample of the estimate;
        # a tiny query measures dispatch overhead, not per-item cost (see
        # QueryPlanner.min_feedback_items).
        big_enough = (build_n + probe_n
                      >= getattr(self.planner, "min_feedback_items", 0))
        if (warmed and solo and not partition_hit
                and not probe_partition_hit and big_enough):
            self.planner.observe(plan, timing)
        wall = self._device_wall(t0)
        return result, plan, timing, (cache_hit, partition_hit,
                                      probe_partition_hit, wall)

    # -- group-by aggregation (ops subsystem) --------------------------------
    def _execute_groupby(self, q: GroupByQuery, queued_s: float = 0.0,
                         ctx: QueryContext | None = None) -> QueryOutcome:
        """Plan + run one group-by under the same locks/feedback regime."""
        obs_key = self._obs_begin(q)
        with self.tracer.span("query", q_key=obs_key, query_id=q.query_id,
                              tenant=q.tenant, tag=q.tag,
                              kind="groupby") as qspan:
            result, plan, timing, wall = self._run_groupby(q, qspan, ctx)
        self.audit.record(self.planner.phase_pairs(plan, timing),
                          tenant=q.tenant, query_id=q.query_id)
        deadline_hit = self._finish_outcome(q)
        outcome = QueryOutcome(q.query_id, q.tag, plan, timing, False,
                               queued_s, wall, result, priority=q.priority,
                               tenant=q.tenant, degraded=q.degraded,
                               deadline_at=q.deadline_at,
                               deadline_hit=deadline_hit)
        if obs_key is not None:
            outcome.trace = self.tracer.spans_for(obs_key)
        self.metrics.observe("query_latency_s", queued_s + wall,
                             tenant=q.tenant)
        self.flight.record_outcome(outcome)
        return outcome

    def _run_groupby(self, q: GroupByQuery, qspan=None,
                     ctx: QueryContext | None = None):
        from ..ops.groupby import groupby_coprocessed
        t0 = time.perf_counter()
        n = q.keys.size
        with self._lock:
            c_load, g_load = self._loads["C"], self._loads["G"]
        with self.tracer.span("plan"):
            plan = self.planner.choose_groupby(n, c_load=c_load,
                                               g_load=g_load)
        if qspan is not None:
            qspan.set(algorithm=plan.algorithm, scheme=plan.scheme)
        plan_key = (plan.algorithm, plan.scheme)
        if not self.breakers.allow(plan_key):
            self.metrics.inc("breaker_short_circuits", tenant=q.tenant)
            self.flight.record_resilience(
                "breaker_short_circuit", phase=plan.algorithm,
                scheme=plan.scheme, query_id=q.query_id, tenant=q.tenant)
            result = self._reference_groupby_result(q)
            timing = Timing(tracer=self.cp.tracer)
            timing.notes["reference_path"] = True
            wall = self._device_wall(t0)
            timing.phase_s["reference"] = wall
            timing.wall_s = wall
            return result, plan, timing, wall
        share = plan.c_share
        with self._lock:
            self._loads["C"] += plan.est_s * share
            self._loads["G"] += plan.est_s * (1.0 - share)
            self._inflight += 1
            inflight_at_start = self._inflight
            start_epoch = self._exec_epoch
            self._exec_epoch += 1
        held = [self.cp.group_locks[g] for g in ("C", "G")
                if g in _plan_groups(plan)]
        for lock in held:
            lock.acquire()
        try:
            result, timing = groupby_coprocessed(
                self.cp, q.keys, q.values, schedule=plan.schedule,
                partition_ratio=plan.partition_ratio,
                agg_ratio=plan.join_ratio, wrap32=q.wrap32, ctx=ctx)
        except Backpressure:
            self.breakers.release(plan_key)
            raise
        except Exception as e:
            e._svc_plan_key = plan_key
            raise
        finally:
            for lock in reversed(held):
                lock.release()
            with self._lock:
                self._loads["C"] -= plan.est_s * share
                self._loads["G"] -= plan.est_s * (1.0 - share)
                self._inflight -= 1
                solo = (inflight_at_start == 1
                        and self._exec_epoch == start_epoch + 1)
        self.breakers.record_success(plan_key)
        # wrap32 belongs in the warm-up signature: the wide (int64 bit-
        # chunk) and wrapping accumulators run different code, so the
        # first wide run after a wrap32 run of the same size is not a
        # warmed sample of it (kept as the reference keys it).
        sig = ("groupby", plan.scheme, n, q.wrap32)
        with self._lock:
            warmed = sig in self._observed_sigs
            self._observed_sigs.add(sig)
        big_enough = n >= getattr(self.planner, "min_feedback_items", 0)
        if warmed and solo and big_enough:
            self.planner.observe(plan, timing)
        wall = self._device_wall(t0)
        return result, plan, timing, wall

    # -- recovery ladder (reference path, retries, breakers) -----------------
    def _reference_join_result(self, q: JoinQuery,
                               max_out: int) -> JoinResult:
        """NumPy reference join honoring the query's variant kind — the
        breaker's quarantine destination and the ladder's last rung.  No
        device work at all, so it cannot share the kernels' failure mode."""
        from ..ops.join_variants import join_variant_oracle
        pairs = join_variant_oracle(q.build, q.probe, q.kind)
        cnt = min(len(pairs), int(max_out))
        probe_rid = torch.from_numpy(pairs[:cnt, 0].astype(np.int32))
        build_rid = torch.from_numpy(pairs[:cnt, 1].astype(np.int32))
        return JoinResult(probe_rid, build_rid,
                          torch.tensor(cnt, dtype=torch.int32))

    def _reference_groupby_result(self, q: GroupByQuery):
        """NumPy reference group-by (the tested oracle) for the ladder."""
        from ..core.hash_table import INVALID
        from ..ops.groupby import groupby_ref
        keys = q.keys.key.cpu().numpy()
        rid = q.keys.rid.cpu().numpy()
        vals = (q.values.cpu().numpy() if isinstance(q.values, torch.Tensor)
                else np.asarray(q.values))
        safe = np.clip(rid, 0, max(vals.shape[0] - 1, 0))
        gathered = np.where(rid >= 0,
                            vals[safe] if vals.shape[0] else 0,
                            0).astype(np.int64)
        live = rid != int(INVALID)
        return groupby_ref(keys[live], gathered[live], wrap32=q.wrap32)

    def _execute_reference(self, q, queued_s: float = 0.0) -> QueryOutcome:
        """Full reference-path execution with honest outcome bookkeeping
        (completed / deadline verdict / latency / flight record)."""
        t0 = time.perf_counter()
        if isinstance(q, GroupByQuery):
            result = self._reference_groupby_result(q)
            plan = self.planner.choose_groupby(q.keys.size, c_load=0.0,
                                               g_load=0.0, record=False)
        else:
            max_out = (q.max_out if q.max_out is not None
                       else 4 * q.probe.size + 1024)
            result = self._reference_join_result(q, max_out)
            plan = self.planner.choose_degraded(
                q.build.size, q.probe.size, max_out=max_out,
                cached=False, kind=q.kind, record=False)
        timing = Timing(tracer=self.cp.tracer)
        timing.notes["reference_path"] = True
        wall = self._device_wall(t0)
        timing.phase_s["reference"] = wall
        timing.wall_s = wall
        deadline_hit = self._finish_outcome(q)
        outcome = QueryOutcome(q.query_id, q.tag, plan, timing, False,
                               queued_s, wall, result, priority=q.priority,
                               tenant=q.tenant, degraded=q.degraded,
                               deadline_at=q.deadline_at,
                               deadline_hit=deadline_hit)
        self.metrics.observe("query_latency_s", queued_s + wall,
                             tenant=q.tenant)
        self.flight.record_outcome(outcome)
        return outcome

    def _note_recovery(self, what: str, q, e, **extra) -> None:
        self.metrics.event("recovery", what=what, tenant=q.tenant,
                           query_id=q.query_id, error=repr(e)[:120],
                           **extra)
        self.tracer.instant(what, tenant=q.tenant, query_id=q.query_id)
        self.flight.record_resilience(what, tenant=q.tenant,
                                      query_id=q.query_id,
                                      error=repr(e)[:120], **extra)

    def _run_with_recovery(self, q, *, enqueued_at: float | None = None
                           ) -> QueryOutcome:
        """The worker-path recovery ladder, engaged for *transient*
        failures only (deterministic errors — bad shapes, malformed
        queries — still fail fast):

          1. bounded retries with seeded jittered backoff;
          2. one degraded (cheapest-plan) retry;
          3. feed the per-(algorithm, scheme) breaker and fall back to
             the NumPy reference path, which always succeeds.

        Preemptions (``Backpressure``) pass straight through — they are
        service decisions, not faults."""
        attempt = 0
        degraded_tried = False
        while True:
            try:
                return self.execute(q, enqueued_at=enqueued_at)
            except Exception as e:
                if isinstance(e, QueueFull) or not self.retry.is_transient(e):
                    raise
                plan_key = getattr(e, "_svc_plan_key", None)
                if plan_key is not None:
                    self.breakers.record_failure(plan_key)
                attempt += 1
                if attempt <= self.retry.max_retries:
                    delay = self.retry.backoff_s(attempt)
                    self.metrics.inc("retries", tenant=q.tenant)
                    self._note_recovery("retry", q, e, attempt=attempt,
                                        backoff_s=round(delay, 5))
                    time.sleep(delay)
                    continue
                if (not degraded_tried and isinstance(q, JoinQuery)
                        and not q.degraded):
                    degraded_tried = True
                    q.degraded = True
                    self._count("degraded", q.tenant)
                    self._note_recovery("degrade_fallback", q, e)
                    continue
                self._note_recovery("reference_fallback", q, e)
                return self._execute_reference(
                    q, queued_s=(0.0 if enqueued_at is None else
                                 max(0.0,
                                     time.perf_counter() - enqueued_at)))

    # -- admission + workers -------------------------------------------------
    def _ensure_workers(self):
        with self._lock:               # concurrent first submits race here
            if self.num_workers <= 0 or self._workers:
                return
            for i in range(self.num_workers):
                t = threading.Thread(target=self._worker_main,
                                     name=f"join-worker-{i}", daemon=True)
                t.start()
                self._workers.append(t)

    def _worker_main(self):
        """Worker supervisor: restart the serving loop if it ever dies
        unexpectedly (restart hygiene — a killed worker must never
        silently shrink service capacity)."""
        while True:
            try:
                self._worker_loop()
                return                 # loop exited normally (stop set)
            except BaseException as e:
                if self._stop.is_set():
                    return
                self.metrics.inc("worker_restarts")
                self.metrics.event("worker_restart", error=repr(e)[:200])
                self.flight.record_resilience("worker_restart",
                                              error=repr(e)[:200])

    def _worker_loop(self):
        while not self._stop.is_set():
            # Fault site BEFORE the dequeue: an injected worker death
            # never strands a claimed item (its waiter would hang).
            maybe_fault("worker")
            try:
                item = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            q, enq_t, box, done = item
            with self._lock:
                self._busy_workers += 1
            try:
                box["outcome"] = self._run_with_recovery(q,
                                                         enqueued_at=enq_t)
            except Exception as e:  # surface to the waiter, keep serving
                # Mark the failure counted: a deferred-stage waiter
                # re-raising this exception must not count it again.
                e._svc_failure_counted = True
                box["error"] = e
                if isinstance(e, QueueFull):
                    # Preempted / shed mid-flight: structured
                    # backpressure, accounted by _note_preempt — a
                    # service decision, never an execution failure.
                    self._note_preempt(e, where="worker")
                else:
                    self._count("failed")
                    self.flight.record_failure(
                        tenant=getattr(q, "tenant", "default"),
                        query_id=getattr(q, "query_id", -1),
                        where="worker", error=repr(e))
            finally:
                with self._lock:
                    self._busy_workers -= 1
                done.set()
                self._queue.task_done()

    # -- admission pricing ---------------------------------------------------
    def _admission_estimate(self, q) -> tuple[float, float]:
        """(est_s, c_share) for admission: the same sticky plan the
        executor will pick, priced without perturbing plan counters."""
        try:
            with self._lock:
                c_load, g_load = self._loads["C"], self._loads["G"]
            if isinstance(q, GroupByQuery):
                plan = self.planner.choose_groupby(
                    q.keys.size, c_load=c_load, g_load=g_load,
                    record=False)
            else:
                build_n, probe_n = q.build.size, q.probe.size
                max_out = (q.max_out if q.max_out is not None
                           else 4 * probe_n + 1024)
                key = self._fingerprint(q.build,
                                        default_num_buckets(build_n),
                                        stage=q.tag, column="build.key",
                                        tenant=q.tenant)
                table = self.cache.peek(key)
                with self._lock:
                    seen = key in self._seen_fingerprints
                plan = self.planner.choose(
                    build_n, probe_n, max_out=max_out,
                    cached=table is not None,
                    expect_reuse=seen and table is None,
                    c_load=c_load, g_load=g_load, kind=q.kind,
                    record=False)
            return float(plan.est_s), float(plan.c_share)
        except Exception:
            return 0.0, 0.5    # unpriceable -> admit-by-count semantics

    def _degraded_estimate(self, q) -> float | None:
        """Cheapest-plan estimate (the degrade option); None when the
        query has no cheaper realizable variant (group-by)."""
        if isinstance(q, GroupByQuery):
            return None
        try:
            build_n, probe_n = q.build.size, q.probe.size
            max_out = (q.max_out if q.max_out is not None
                       else 4 * probe_n + 1024)
            key = self._fingerprint(q.build, default_num_buckets(build_n),
                                    stage=q.tag, column="build.key",
                                    tenant=q.tenant)
            plan = self.planner.choose_degraded(
                build_n, probe_n, max_out=max_out,
                cached=self.cache.peek(key) is not None, kind=q.kind,
                record=False)
            return float(plan.est_s)
        except Exception:
            return None

    def _stamp_deadline(self, q, now: float) -> None:
        """Resolve the query's absolute deadline: explicit ``deadline_at``
        wins, then a relative ``deadline_s``, then the tenant's default
        deadline class."""
        if q.deadline_at is not None:
            return
        rel = q.deadline_s
        if rel is None:
            rel = self.admission.tenant(q.tenant).deadline_s
        if rel is not None:
            q.deadline_at = now + float(rel)

    def _admission_snapshot(self, tenant: str) -> tuple[float, float]:
        """(in-flight estimated seconds, active fair-share weight)."""
        with self._lock:
            inflight = sum(self._loads.values())
        active = set(self._queue.active_tenants()) | {tenant}
        active_w = sum(self.admission.tenant(x).weight for x in active)
        return inflight, active_w

    def submit(self, q, *, block: bool = True,
               timeout: float | None = None, preadmitted: bool = False):
        """Admit a query.  Returns a ``wait()``-able handle.

        Deadline-aware: a query whose predicted completion misses its
        deadline is degraded to the cheapest plan when that still fits,
        else shed with a structured ``Backpressure`` (counted in
        ``shed``).  Non-blocking submits raise ``Backpressure`` (a
        ``QueueFull``) when the admission queue is at capacity (counted
        in ``rejected``).  ``preadmitted`` skips the shed/degrade
        decision — pipeline stages whose root already passed admission.
        """
        tenant = q.tenant or "default"
        with self._lock:
            closing = self._closing
        if closing:
            bp = Backpressure(
                f"service closing, query {q.query_id} not admitted",
                reason="service_closing", tenant=tenant,
                query_id=q.query_id, retry_after_s=0.1)
            self._admission_event("reject", bp)
            raise bp
        self._ensure_workers()
        tr = self.tracer
        if tr.enabled and getattr(q, "_obs_key", None) is None:
            q._obs_key = tr.next_key()
        with tr.span("admit", q_key=getattr(q, "_obs_key", None),
                     query_id=q.query_id, tenant=tenant, tag=q.tag):
            est, c_share = self._admission_estimate(q)
            now = self._clock()
            self._stamp_deadline(q, now)
            if (not preadmitted and self.admission.mode == "cost"
                    and q.deadline_at is not None):
                inflight, active_w = self._admission_snapshot(tenant)
                decision = self.admission.decide(
                    tenant, est_s=est, deadline_s=q.deadline_at - now,
                    degraded_est_fn=lambda: self._degraded_estimate(q),
                    c_share=c_share, inflight_s=inflight,
                    tenant_backlog_s=self._queue.backlog_s(tenant),
                    active_weight=active_w)
                if decision.action == "shed":
                    bp = Backpressure(
                        f"query {q.query_id} shed: predicted completion "
                        f"{decision.predicted_s:.3f}s misses deadline "
                        f"{q.deadline_at - now:.3f}s "
                        f"(retry after {decision.retry_after_s:.3f}s)",
                        reason="deadline", tenant=tenant,
                        query_id=q.query_id,
                        retry_after_s=decision.retry_after_s,
                        predicted_s=decision.predicted_s,
                        deadline_s=q.deadline_at - now)
                    self._admission_event("shed", bp)
                    raise bp
                if decision.action == "degrade":
                    q.degraded = True
                    self._count("degraded", tenant)
                    self.metrics.event(
                        "admission", action="degrade", reason="deadline",
                        tenant=tenant, query_id=q.query_id,
                        predicted_s=decision.predicted_s,
                        deadline_s=q.deadline_at - now,
                        retry_after_s=decision.retry_after_s)
                    tr.instant("degrade", tenant=tenant,
                               query_id=q.query_id)
                    self.flight.record_admission(
                        "degrade", tenant=tenant, query_id=q.query_id,
                        predicted_s=decision.predicted_s)
            box: dict = {}
            done = threading.Event()
            try:
                if tr.enabled:
                    q._obs_enq = tr.now()
                self._queue.put((q, time.perf_counter(), box, done),
                                priority=q.priority, block=block,
                                timeout=timeout, tenant=tenant,
                                deadline_at=q.deadline_at, est_s=est)
            except queue.Full:
                with self._lock:
                    inflight = sum(self._loads.values())
                backlog = self._queue.backlog_s()
                bp = Backpressure(
                    f"admission queue full (query {q.query_id})",
                    reason="queue_full", tenant=tenant,
                    query_id=q.query_id,
                    retry_after_s=max(0.05, (inflight + backlog)
                                     / max(1, self.num_workers)))
                self._admission_event("reject", bp)
                raise bp
            self._count("admitted", tenant)

        def wait(timeout: float | None = None) -> QueryOutcome:
            if not done.wait(timeout):
                raise TimeoutError(f"query {q.query_id} still running")
            if "error" in box:
                raise box["error"]
            return box["outcome"]

        return wait

    def admit_pipeline(self, *, tenant: str = "default",
                       est_s: float = 0.0,
                       deadline_s: float | None = None,
                       deadline_at: float | None = None,
                       query_id: int = -1,
                       degraded_est_s: float | None = None
                       ) -> tuple[float | None, bool]:
        """Admit (or shed) a whole pipeline up front on its total cost.

        Returns ``(deadline_at, degraded)``: the absolute deadline every
        stage of the pipeline should carry (``None`` when neither the
        caller nor the tenant's deadline class sets one) and whether the
        pipeline must run its stages degraded.  Raises ``Backpressure``
        when the predicted completion cannot meet the deadline even
        degraded — the whole pipeline is shed coherently instead of
        failing half-way through.
        """
        tenant = tenant or "default"
        now = self._clock()
        if deadline_at is None:
            rel = deadline_s
            if rel is None:
                rel = self.admission.tenant(tenant).deadline_s
            if rel is not None:
                deadline_at = now + float(rel)
        if (self.admission.mode != "cost" or deadline_at is None):
            return deadline_at, False
        inflight, active_w = self._admission_snapshot(tenant)
        decision = self.admission.decide(
            tenant, est_s=est_s, deadline_s=deadline_at - now,
            degraded_est_fn=(None if degraded_est_s is None
                             else (lambda: degraded_est_s)),
            inflight_s=inflight,
            tenant_backlog_s=self._queue.backlog_s(tenant),
            active_weight=active_w)
        if decision.action == "shed":
            bp = Backpressure(
                f"pipeline {query_id} shed: predicted completion "
                f"{decision.predicted_s:.3f}s misses deadline "
                f"{deadline_at - now:.3f}s "
                f"(retry after {decision.retry_after_s:.3f}s)",
                reason="deadline", tenant=tenant, query_id=query_id,
                retry_after_s=decision.retry_after_s,
                predicted_s=decision.predicted_s,
                deadline_s=deadline_at - now)
            self._admission_event("shed", bp)
            raise bp
        if decision.action == "degrade":
            self._count("degraded", tenant)
            self.metrics.event(
                "admission", action="degrade", reason="deadline",
                tenant=tenant, query_id=query_id,
                predicted_s=decision.predicted_s,
                deadline_s=deadline_at - now,
                retry_after_s=decision.retry_after_s)
            self.flight.record_admission(
                "degrade", tenant=tenant, query_id=query_id,
                predicted_s=decision.predicted_s)
            return deadline_at, True
        return deadline_at, False

    def submit_deferred(self, make_query, deps=(), *, finalize=None,
                        priority: int | None = None,
                        tenant: str | None = None,
                        deadline_at: float | None = None,
                        preadmitted: bool = True,
                        block: bool = True,
                        timeout: float | None = None):
        """Admit one pipeline stage that depends on earlier stages.

        ``make_query(dep_outcomes)`` is called — with the outcomes of the
        ``deps`` handles, in order — only once they have all resolved, and
        must return the stage's ``JoinQuery`` (its inputs typically do not
        exist before its dependencies finish).  ``finalize(outcome)``, when
        given, runs before the returned handle resolves; the query-pipeline
        executor publishes stage intermediates there so dependent stages
        always find them — on the fused path those are *device handles*
        (``StageView``: result rid vectors still resident on device), not
        host rows, and the per-device-group locks already serialize any
        group work the dependents dispatch.  Returns a ``wait()``-able like
        ``submit``.  Stages with disjoint dependency sets go through the
        normal admission queue concurrently — that is where independent
        subtrees of a join tree overlap on the two device groups.

        Deferred stages are *bounded*: each holds one slot of the service's
        deferred-stage semaphore while pending, so a deep or wide pipeline
        cannot spawn unbounded threads past admission (non-blocking submits
        raise ``Backpressure`` when no slot is free).  The stage inherits
        its tenant and absolute deadline from its dependencies' outcomes —
        or takes the explicit ``tenant``/``deadline_at`` overrides — so a
        whole pipeline is admitted or shed coherently; ``preadmitted``
        (default) skips per-stage shed/degrade decisions because the root
        decision via ``admit_pipeline`` already covered the pipeline.
        """
        if not self._deferred_sem.acquire(blocking=block, timeout=timeout):
            bp = Backpressure(
                "deferred-stage capacity exhausted",
                reason="queue_full", tenant=tenant or "default",
                retry_after_s=0.05)
            self._admission_event("reject", bp)
            raise bp
        box: dict = {}
        done = threading.Event()

        def runner():
            try:
                try:
                    outs = [d() for d in deps]
                except Exception as e:
                    # Dep failures propagate but were already counted at
                    # the failing stage — don't double-count here.
                    box["error"] = e
                    return
                try:
                    q = make_query(outs)
                    if priority is not None:
                        q.priority = priority
                    # Inherit tenant/deadline: explicit override first,
                    # then the dependencies' outcomes, then the query's
                    # own fields.
                    if tenant is not None:
                        q.tenant = tenant
                    elif outs and getattr(q, "tenant", "default") == "default":
                        q.tenant = outs[0].tenant
                    if deadline_at is not None:
                        q.deadline_at = deadline_at
                    elif q.deadline_at is None and outs:
                        q.deadline_at = outs[0].deadline_at
                    if self.num_workers <= 0:
                        out = self.execute(q)
                    else:
                        out = self.submit(q, preadmitted=preadmitted)()
                    if finalize is not None:
                        finalize(out)
                    box["outcome"] = out
                except Exception as e:
                    # Admission outcomes (shed / queue-full) are already
                    # counted as shed/rejected, not execution failures.
                    if (not isinstance(e, QueueFull)
                            and not getattr(e, "_svc_failure_counted",
                                            False)):
                        e._svc_failure_counted = True
                        self._count("failed")
                        self.flight.record_failure(
                            tenant=tenant or "default",
                            where="deferred", error=repr(e))
                    box["error"] = e
            finally:
                self._deferred_sem.release()
                done.set()

        threading.Thread(target=runner, daemon=True,
                         name="join-deferred").start()

        def wait(timeout: float | None = None) -> QueryOutcome:
            if not done.wait(timeout):
                raise TimeoutError("deferred query still running")
            if "error" in box:
                raise box["error"]
            return box["outcome"]

        return wait

    def run(self, queries) -> list[QueryOutcome]:
        """Drain a whole workload; outcomes in submission order."""
        if self.num_workers <= 0:
            return [self.execute(q) for q in queries]
        waiters = [self.submit(q) for q in queries]
        return [w() for w in waiters]

    # -- lifecycle / stats ---------------------------------------------------
    def close(self, drain: bool = True, timeout: float = 5.0):
        """Shut the service down.

        ``drain=True`` (default) lets the workers finish everything
        already admitted (bounded by ``timeout`` of *real* wall time —
        the injectable clock may be fake and would never advance a drain
        wait) before stopping them; ``drain=False`` stops them at the
        next dequeue.  Either way, anything still queued afterwards is
        cancelled with a structured ``Backpressure(service_closing)`` —
        a shutdown decision, not an execution failure — so no waiter
        ever blocks on a queue nobody drains.  Once closed, ``submit``
        rejects with the same structured error; direct ``execute`` calls
        still work.
        """
        with self._lock:
            self._closing = True
        if drain and self._workers:
            end = time.monotonic() + float(timeout)
            while time.monotonic() < end:
                with self._lock:
                    busy = self._busy_workers
                if len(self._queue) == 0 and busy == 0:
                    break
                time.sleep(0.005)
        self._stop.set()
        for t in self._workers:
            t.join(timeout=float(timeout))
        # Cancel queries still sitting in the admission queue.
        for item in self._queue.drain():
            q, _, box, done = item
            bp = Backpressure(
                f"service closed before query {q.query_id} ran",
                reason="service_closing",
                tenant=getattr(q, "tenant", "default"),
                query_id=getattr(q, "query_id", -1))
            box["error"] = bp
            done.set()
            self.metrics.inc("cancelled_on_close",
                             tenant=getattr(q, "tenant", "default"))
            self.metrics.event("admission", action="cancel",
                               **bp.to_dict())
            self.flight.record_admission("cancel", **bp.to_dict())
        self._workers.clear()
        self._stop.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def stats(self) -> dict:
        """One coherent snapshot, routed through ``metrics.snapshot()``.

        All service counters (global and per-tenant) come out of a single
        locked registry read; queue depth, cache, planner and audit state
        are registry collectors invoked in the same pass — the old
        counters-then-components split (where ``queue_depth`` and
        ``cache.stats()`` were read at a later instant than the counter
        snapshot) is gone.  The full registry snapshot rides along under
        ``"metrics"`` for consumers that want the labeled series, the
        prediction-error summary, or the calibration version.
        """
        snap = self.metrics.snapshot()
        counters = {name: int(snap.get(name, 0))
                    for name in ("admitted", "rejected", "completed",
                                 "failed", "shed", "degraded")}
        tenants: dict[str, dict] = {}
        for name in self._TENANT_COUNTERS:
            prefix = name + "{tenant="
            for key, value in snap.items():
                if (isinstance(key, str) and key.startswith(prefix)
                        and key.endswith("}")):
                    t = key[len(prefix):-1]
                    tenants.setdefault(
                        t, {n: 0 for n in self._TENANT_COUNTERS}
                    )[name] = int(value)
        resilience = {name: int(self.metrics.counter_value(name))
                      for name in self._RESILIENCE_COUNTERS}
        resilience["breakers"] = snap.get("breakers")
        resilience["budget"] = snap.get("budget")
        return {**counters,
                "host_bytes_moved": int(snap.get("host_bytes_moved", 0)),
                "queue_depth": snap.get("queue_depth", 0),
                "tenants": tenants, "cache": snap.get("cache"),
                "planner": snap.get("planner"),
                "flight": snap.get("flight"), "slo": snap.get("slo"),
                "drift": snap.get("drift"),
                "host_transfer_ledger": snap.get("host_transfer_ledger"),
                "cardinality_error": snap.get("cardinality_error"),
                "resilience": resilience,
                "metrics": snap}
