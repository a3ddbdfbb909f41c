"""Multi-tenant, deadline-aware admission for ``JoinQueryService``.

A copy of ``repro/engine/admission.py`` (no framework imports).

The planner already *predicts* per-query runtime (``QueryPlan.est_s``);
this module turns that prediction into serving policy — the layer the
query-acceleration survey flags as what discrete-GPU engines lack:

  * ``Tenant`` — a budgeted workload container: fair-share ``weight``, a
    default ``deadline_s`` class, and C/G resource-share budgets that cap
    the service rate its admission pricing may assume.
  * ``TenantFairQueue`` — the two-level scheduler replacing the single
    priority queue: weighted fair share *across* tenants (stride-style
    virtual time, advanced by each dequeued query's estimated seconds
    over the tenant's weight), earliest-deadline-first *within* a tenant
    (no-deadline queries fall back to the old aged-priority order, so
    single-tenant traffic behaves exactly as before).
  * ``AdmissionController`` — the admit / degrade / shed decision: a
    query's predicted completion (current in-flight load + the tenant's
    queued backlog at its fair service rate + its own estimate) is
    compared against its deadline at admission time.  A hopeless query is
    first re-priced with the planner's cheapest plan (*degrade*); if even
    that misses, it is *shed* with a structured ``Backpressure`` error
    carrying a retry-after hint — callers get an immediate, actionable
    signal instead of a timeout.

Everything takes an injectable ``clock`` so scheduling decisions are
deterministically testable.
"""
from __future__ import annotations

import dataclasses
import math
import queue
import threading
import time


class QueueFull(RuntimeError):
    """Admission rejected: the service is at capacity."""


class Backpressure(QueueFull):
    """Structured admission rejection (shed / capacity backpressure).

    Subclasses ``QueueFull`` so existing callers' except clauses keep
    working; carries the machine-readable context a client needs to back
    off sensibly instead of guessing from a timeout.
    """

    def __init__(self, msg: str, *, reason: str = "shed",
                 tenant: str = "default", query_id: int = -1,
                 retry_after_s: float = 0.0,
                 predicted_s: float | None = None,
                 deadline_s: float | None = None):
        super().__init__(msg)
        self.reason = reason            # "deadline" | "queue_full" | ...
        self.tenant = tenant
        self.query_id = query_id
        self.retry_after_s = float(retry_after_s)
        self.predicted_s = predicted_s  # predicted completion (relative s)
        self.deadline_s = deadline_s    # the deadline it would have missed

    def to_dict(self) -> dict:
        return {"reason": self.reason, "tenant": self.tenant,
                "query_id": self.query_id,
                "retry_after_s": self.retry_after_s,
                "predicted_s": self.predicted_s,
                "deadline_s": self.deadline_s}


@dataclasses.dataclass
class Tenant:
    """One workload container sharing the engine.

    ``weight`` drives the cross-tenant fair share (2.0 gets twice the
    service rate of 1.0 under contention).  ``deadline_s`` is the
    tenant's default deadline class — queries without an explicit
    deadline inherit it (``None`` = best-effort, never shed on deadline).
    ``c_budget``/``g_budget`` bound the share of each device group the
    tenant's admission pricing may assume (a tenant budgeted at 0.25 of C
    cannot count on more than a quarter of the C-group's service rate
    when predicting completion, however idle the engine is — the simpy
    Container idiom priced instead of locked).
    """

    name: str
    weight: float = 1.0
    deadline_s: float | None = None
    c_budget: float = 1.0
    g_budget: float = 1.0


@dataclasses.dataclass
class AdmissionDecision:
    action: str                   # "admit" | "degrade" | "shed"
    predicted_s: float            # predicted completion, relative seconds
    retry_after_s: float = 0.0

    def to_dict(self) -> dict:
        """Structured-event payload: the service emits every shed/degrade
        into its ``MetricsRegistry`` so consumers (``slo_bench``) read
        decisions from metrics instead of re-deriving them from raised
        ``Backpressure`` exceptions."""
        return {"action": self.action,
                "predicted_s": float(self.predicted_s),
                "retry_after_s": float(self.retry_after_s)}


@dataclasses.dataclass
class _Entry:
    priority: int
    seq: int
    enq_t: float
    deadline_at: float | None
    est_s: float
    item: object


class TenantFairQueue:
    """Bounded two-level scheduler: weighted fair share across tenants,
    EDF within a tenant.

    Each tenant owns a lane.  Lane selection is stride scheduling over
    per-tenant virtual time: dequeuing a query advances its tenant's
    vtime by ``max(est_s, est_floor_s) / weight``, so under contention a
    weight-2 tenant receives twice the estimated service seconds of a
    weight-1 tenant — *cost*-weighted fairness, not query-count fairness.
    A tenant going active after idling is clamped to the minimum active
    vtime (idle time is not banked).  Within a lane the earliest deadline
    wins; queries without a deadline sort after all deadlined ones by
    aged priority (exactly the old ``PriorityAgingQueue`` order, so
    deadline-free single-tenant traffic is unchanged).  ``fifo=True``
    degrades the whole thing to a count-only FIFO — the baseline the
    ``slo_bench`` benchmark measures cost-aware admission against.

    ``weight_fn`` maps a tenant name to its weight (late registrations
    seen live); ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, maxsize: int = 0, *, aging_s: float = 5.0,
                 clock=time.monotonic, weight_fn=None, fifo: bool = False,
                 est_floor_s: float = 1e-3):
        self.maxsize = int(maxsize)
        self.aging_s = float(aging_s)
        self._clock = clock
        self._weight_fn = weight_fn or (lambda tenant: 1.0)
        self.fifo = bool(fifo)
        self.est_floor_s = float(est_floor_s)
        self._lanes: dict[str, list[_Entry]] = {}
        self._vtime: dict[str, float] = {}
        self._backlog: dict[str, float] = {}
        self._cond = threading.Condition()
        self._seq = 0
        self._size = 0

    def __len__(self) -> int:
        with self._cond:
            return self._size

    qsize = __len__

    def active_tenants(self) -> list[str]:
        with self._cond:
            return [t for t, lane in self._lanes.items() if lane]

    def backlog_s(self, tenant: str | None = None) -> float:
        """Summed estimated seconds queued (for one tenant, or all)."""
        with self._cond:
            if tenant is not None:
                return self._backlog.get(tenant, 0.0)
            return sum(self._backlog.values())

    def put(self, item, priority: int = 0, block: bool = True,
            timeout: float | None = None, *, tenant: str = "default",
            deadline_at: float | None = None, est_s: float = 0.0):
        with self._cond:
            if self.maxsize > 0:
                if not block and self._size >= self.maxsize:
                    raise queue.Full
                end = None if timeout is None else self._clock() + timeout
                while self._size >= self.maxsize:
                    rem = None if end is None else end - self._clock()
                    if rem is not None and rem <= 0:
                        raise queue.Full
                    if not self._cond.wait(rem):
                        raise queue.Full
            self._seq += 1
            lane = self._lanes.setdefault(tenant, [])
            if not lane:
                # Fresh-active tenant: clamp to the active minimum so idle
                # time is not banked into a starvation-length head start.
                floor = min((self._vtime[t] for t, ln in self._lanes.items()
                             if ln and t != tenant), default=0.0)
                self._vtime[tenant] = max(self._vtime.get(tenant, 0.0),
                                          floor)
            lane.append(_Entry(int(priority), self._seq, self._clock(),
                               deadline_at, max(0.0, float(est_s)), item))
            self._backlog[tenant] = self._backlog.get(tenant, 0.0) + \
                max(0.0, float(est_s))
            self._size += 1
            self._cond.notify()

    def _pop_best(self):
        now = self._clock()
        active = [t for t, lane in self._lanes.items() if lane]
        if self.fifo:
            # Count-only baseline: global arrival order, tenants ignored.
            t = min(active, key=lambda x: self._lanes[x][0].seq)
            lane = self._lanes[t]
            i = min(range(len(lane)), key=lambda j: lane[j].seq)
        else:
            # Level 1: weighted fair share — smallest virtual time wins
            # (name tie-break keeps selection deterministic under tests).
            t = min(active, key=lambda x: (self._vtime.get(x, 0.0), x))
            lane = self._lanes[t]

            # Level 2: EDF; deadline-free entries sort after every
            # deadlined one, ordered by aged priority then FIFO.
            def key(e: _Entry):
                dl = math.inf if e.deadline_at is None else e.deadline_at
                aged = e.priority + (now - e.enq_t) / self.aging_s
                return (dl, -aged, e.seq)

            i = min(range(len(lane)), key=lambda j: key(lane[j]))
        e = lane.pop(i)
        if not self.fifo:
            w = max(float(self._weight_fn(t)), 1e-6)
            self._vtime[t] = self._vtime.get(t, 0.0) + \
                max(e.est_s, self.est_floor_s) / w
        self._backlog[t] = max(0.0, self._backlog.get(t, 0.0) - e.est_s)
        self._size -= 1
        self._cond.notify()          # a blocked put may now have room
        return e.item

    def get(self, timeout: float | None = None):
        with self._cond:
            end = None if timeout is None else self._clock() + timeout
            while not self._size:
                rem = None if end is None else end - self._clock()
                if rem is not None and rem <= 0:
                    raise queue.Empty
                if not self._cond.wait(rem):
                    raise queue.Empty
            return self._pop_best()

    def get_nowait(self):
        with self._cond:
            if not self._size:
                raise queue.Empty
            return self._pop_best()

    def drain(self) -> list:
        """Remove and return every queued item at once (service close:
        the caller cancels each with a structured error).  Blocked
        ``put`` calls wake to the freed capacity."""
        with self._cond:
            items = [e.item for lane in self._lanes.values() for e in lane]
            self._lanes.clear()
            self._backlog.clear()
            self._size = 0
            self._cond.notify_all()
        return items

    def task_done(self):              # queue.Queue API compat (no join())
        pass


class AdmissionController:
    """Admit / degrade / shed, priced by the planner's estimates.

    Predicted completion for a query from tenant *t*:

        wait = inflight_s / workers  +  backlog_t / (workers * share_t)
        share_t = min(weight_t / active_weight,
                      c_budget*c_share + g_budget*(1 - c_share))

    i.e. the in-flight work drains across all workers, but the tenant's
    *queued* backlog drains only at its fair (and budget-capped) share of
    the service rate.  ``mode="fifo"`` disables deadline decisions
    entirely — the count-only baseline.
    """

    def __init__(self, tenants=None, *, num_workers: int = 2,
                 mode: str = "cost", min_retry_s: float = 0.05):
        if mode not in ("cost", "fifo"):
            raise ValueError(f"unknown admission mode {mode!r}")
        self.mode = mode
        self.num_workers = max(1, int(num_workers))
        self.min_retry_s = float(min_retry_s)
        self._tenants: dict[str, Tenant] = {}
        # Per-tenant safety margins on estimate pricing (>= 1.0): the
        # drift detector widens a tenant's margin when its measured/
        # estimated ratio runs sustainedly high, so admission predicts
        # completion from estimates inflated to what this tenant's
        # queries actually cost — prediction error fed back into
        # admission (ROADMAP item 1).
        self._margins: dict[str, float] = {}
        self._lock = threading.Lock()
        for t in (tenants or ()):
            self.register(t)

    def register(self, tenant: Tenant) -> Tenant:
        with self._lock:
            self._tenants[tenant.name] = tenant
        return tenant

    def tenant(self, name: str) -> Tenant:
        """Look up a tenant, auto-registering defaults for unknown names
        (best-effort weight-1 container) so untagged traffic just works."""
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                t = self._tenants[name] = Tenant(name)
            return t

    def tenants(self) -> list[Tenant]:
        with self._lock:
            return list(self._tenants.values())

    def weight_of(self, name: str) -> float:
        return self.tenant(name).weight

    def set_margin(self, name: str, margin: float) -> None:
        """Set a tenant's estimate safety margin (clamped to >= 1.0)."""
        with self._lock:
            self._margins[name] = max(1.0, float(margin))

    def margin_of(self, name: str) -> float:
        with self._lock:
            return self._margins.get(name, 1.0)

    def margins(self) -> dict[str, float]:
        with self._lock:
            return dict(self._margins)

    def decide(self, tenant_name: str, *, est_s: float,
               deadline_s: float | None, degraded_est_fn=None,
               c_share: float = 0.5, inflight_s: float = 0.0,
               tenant_backlog_s: float = 0.0,
               active_weight: float | None = None) -> AdmissionDecision:
        """One admission decision.  ``deadline_s`` is relative (seconds
        from now); ``degraded_est_fn`` lazily prices the cheapest plan —
        only evaluated when the preferred plan already misses."""
        t = self.tenant(tenant_name)
        # The drift-priced safety margin inflates every estimate used in
        # this decision: a tenant whose queries sustainedly run over
        # estimate is priced at what they actually cost.
        margin = self.margin_of(tenant_name)
        est_s = max(0.0, float(est_s)) * margin
        total_w = max(active_weight if active_weight else t.weight, 1e-9)
        share = t.weight / total_w
        budget_cap = (t.c_budget * c_share
                      + t.g_budget * (1.0 - c_share))
        share = max(min(share, budget_cap), 1e-6)
        wait = (inflight_s / self.num_workers
                + tenant_backlog_s / (self.num_workers * share))
        predicted = wait + est_s
        if self.mode != "cost" or deadline_s is None:
            return AdmissionDecision("admit", predicted)
        if predicted <= deadline_s:
            return AdmissionDecision("admit", predicted)
        degraded_est = degraded_est_fn() if degraded_est_fn else None
        if degraded_est is not None:
            degraded_est = float(degraded_est) * margin
        if degraded_est is not None and wait + degraded_est <= deadline_s:
            return AdmissionDecision("degrade", wait + degraded_est)
        cheapest = min([x for x in (est_s, degraded_est)
                        if x is not None] or [0.0])
        retry = max(self.min_retry_s, wait + cheapest - deadline_s)
        return AdmissionDecision("shed", predicted, retry_after_s=retry)


def jain_index(values) -> float:
    """Jain's fairness index over per-tenant allocations: 1.0 = perfectly
    even, 1/n = one tenant took everything."""
    xs = [max(0.0, float(v)) for v in values]
    if not xs or sum(xs) == 0.0:
        return 1.0
    return (sum(xs) ** 2) / (len(xs) * sum(x * x for x in xs))
