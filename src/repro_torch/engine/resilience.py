"""Resilience layer: preemption context, budget enforcement, recovery.

A copy of ``repro/engine/resilience.py`` (no framework imports).

Admission (``admission.py``) prices risk once, up front.  This module is
what can still act *after* a query starts running:

  * :class:`QueryContext` — cancel token + absolute deadline + tenant
    budget meter, threaded from ``JoinQueryService.execute`` into
    ``CoProcessor.phj`` / ``groupby`` and checked cooperatively at radix
    pass boundaries and between pipeline waves.  A blown deadline raises
    :class:`DeadlineExceeded` (same ``QueueFull``/``Backpressure`` family
    admission sheds with, so every caller's structured-error handling
    already covers it); completed partition passes are checkpointed so a
    re-admitted query resumes instead of restarting.
  * :class:`BudgetEnforcer` — per-(tenant, device-group) token buckets
    fed by *measured* phase seconds off the ``CostAudit`` listener
    stream.  A tenant that under-predicted its C/G budget is throttled
    (short sleep at the next pass boundary) and, past a debt bound,
    preempted with :class:`BudgetExceeded` — budgets stop being
    admission-time fiction.
  * :class:`RetryPolicy` + :class:`BreakerBoard` — the service's recovery
    ladder: bounded seeded-jitter retries for *transient* faults, one
    degraded (cheapest-plan) retry, then per-``(algorithm, scheme)``
    circuit breakers that quarantine a repeatedly failing kernel variant
    and route it to the NumPy reference path until a half-open trial
    succeeds.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time

from .admission import Backpressure

# Breaker states (the ``breaker_state`` gauge values).
CLOSED, OPEN, HALF_OPEN = 0, 1, 2
_STATE_NAMES = {CLOSED: "closed", OPEN: "open", HALF_OPEN: "half_open"}


class DeadlineExceeded(Backpressure):
    """Raised mid-flight when a query's absolute deadline has passed.

    Subclasses ``Backpressure`` (hence ``QueueFull``): preemption is a
    structured service decision, not an execution failure — callers that
    already treat sheds as backpressure handle it unchanged."""


class BudgetExceeded(Backpressure):
    """Raised when a tenant's measured C/G device-seconds debt exceeds
    the enforcement bound (runtime budget enforcement, not admission
    pricing)."""


class Cancelled(Backpressure):
    """The query's cancel token fired (service shutdown / caller abort)."""


@dataclasses.dataclass
class QueryContext:
    """Per-query cooperative control block.

    ``check(where)`` is called at pass boundaries (cheap: a clock read
    and two branches); it raises the structured abort or sleeps off a
    budget throttle.  ``note_partial`` captures a partially-partitioned
    relation when an abort lands mid-partitioning, so the service can
    checkpoint it under a schedule-prefix cache key.
    """

    query_id: int = -1
    tenant: str = "default"
    deadline_at: float | None = None
    clock: object = time.monotonic
    cancel: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    enforcer: "BudgetEnforcer | None" = None
    on_throttle: object = None       # fn(tenant, delay_s) | None
    # tag ("R"/"S") -> (partial Relation, completed pass count)
    partials: dict = dataclasses.field(default_factory=dict)
    # Resume bookkeeping the service fills in: tag -> completed passes of
    # the checkpoint the side was restored from.
    resume_from: dict = dataclasses.field(default_factory=dict)
    # Service-side metadata (cache keys, schedule) for checkpointing.
    meta: dict = dataclasses.field(default_factory=dict)

    def check(self, where: str = "") -> None:
        if self.cancel.is_set():
            raise Cancelled(
                f"query {self.query_id} cancelled at {where or 'check'}",
                reason="cancelled", tenant=self.tenant,
                query_id=self.query_id)
        if self.deadline_at is not None and self.clock() > self.deadline_at:
            raise DeadlineExceeded(
                f"query {self.query_id} deadline passed at "
                f"{where or 'check'}", reason="deadline_exceeded",
                tenant=self.tenant, query_id=self.query_id,
                deadline_s=0.0)
        if self.enforcer is not None:
            verdict, amount = self.enforcer.check(self.tenant)
            if verdict == "throttle":
                if self.on_throttle is not None:
                    self.on_throttle(self.tenant, amount)
                time.sleep(amount)
            elif verdict == "preempt":
                raise BudgetExceeded(
                    f"tenant {self.tenant} exceeded its device-seconds "
                    f"budget by {amount:.3f}s (query {self.query_id} "
                    f"preempted at {where or 'check'})",
                    reason="budget", tenant=self.tenant,
                    query_id=self.query_id, retry_after_s=amount)

    def note_partial(self, tag: str, rel, passes_done: int) -> None:
        if passes_done > 0:
            self.partials[tag] = (rel, int(passes_done))


# Scheme -> C-group share of measured phase seconds (mirrors the planner's
# quantized execution: single-group schemes are exact, split schemes are
# charged half-and-half — enforcement is a bound, not an attribution).
_SCHEME_C_SHARE = {"CPU_ONLY": 1.0, "GPU_ONLY": 0.0}


class _TokenBucket:
    """Seconds-of-device-time bucket: refills at ``rate`` per wall
    second up to ``burst_s``; charges may drive it negative (debt)."""

    def __init__(self, rate: float, burst_s: float, now: float):
        self.rate = float(rate)
        self.burst_s = float(burst_s)
        self.level = float(burst_s)
        self.last_t = float(now)

    def _refill(self, now: float) -> None:
        dt = max(0.0, now - self.last_t)
        self.last_t = now
        self.level = min(self.burst_s, self.level + dt * self.rate)

    def charge(self, amount: float, now: float) -> None:
        self._refill(now)
        self.level -= float(amount)

    def debt(self, now: float) -> float:
        self._refill(now)
        return max(0.0, -self.level)


class BudgetEnforcer:
    """Runtime C/G budget enforcement off the measured-cost stream.

    Registered as a ``CostAudit`` listener: every executed phase's
    *measured* seconds are charged to the billed tenant's per-group
    bucket, split by the executed scheme.  Bucket refill rate is the
    tenant's ``c_budget``/``g_budget`` share (device-seconds per wall
    second); ``burst_s`` seconds of headroom absorb normal variance.
    ``check`` is consulted at pass boundaries: small debt throttles
    (bounded sleep proportional to the debt), debt past
    ``preempt_debt_s`` preempts.
    """

    def __init__(self, admission, *, burst_s: float = 1.0,
                 preempt_debt_s: float = 2.0,
                 max_throttle_s: float = 0.05,
                 clock=time.monotonic, metrics=None):
        self.admission = admission
        self.burst_s = float(burst_s)
        self.preempt_debt_s = float(preempt_debt_s)
        self.max_throttle_s = float(max_throttle_s)
        self._clock = clock
        self.metrics = metrics
        self._lock = threading.Lock()
        self._buckets: dict[tuple[str, str], _TokenBucket] = {}

    def _bucket(self, tenant: str, group: str, now: float) -> _TokenBucket:
        key = (tenant, group)
        b = self._buckets.get(key)
        if b is None:
            t = self.admission.tenant(tenant)
            rate = t.c_budget if group == "C" else t.g_budget
            b = self._buckets[key] = _TokenBucket(
                max(rate, 1e-6), self.burst_s, now)
        return b

    def on_record(self, rec: dict) -> None:
        """CostAudit listener: charge one measured phase."""
        measured = float(rec.get("measured_s") or 0.0)
        if measured <= 0.0:
            return
        tenant = rec.get("tenant") or "default"
        c_share = _SCHEME_C_SHARE.get(rec.get("scheme"), 0.5)
        now = self._clock()
        with self._lock:
            if c_share > 0.0:
                self._bucket(tenant, "C", now).charge(
                    measured * c_share, now)
            if c_share < 1.0:
                self._bucket(tenant, "G", now).charge(
                    measured * (1.0 - c_share), now)

    def check(self, tenant: str) -> tuple[str, float]:
        """("ok" | "throttle" | "preempt", delay-or-debt seconds)."""
        now = self._clock()
        with self._lock:
            debt = max((b.debt(now)
                        for (t, _), b in self._buckets.items()
                        if t == tenant), default=0.0)
        if debt <= 0.0:
            return "ok", 0.0
        if debt >= self.preempt_debt_s:
            return "preempt", debt
        return "throttle", min(self.max_throttle_s, debt)

    def summary(self) -> dict:
        now = self._clock()
        with self._lock:
            return {f"{t}/{g}": {"level": round(b.level, 4),
                                 "rate": b.rate}
                    for (t, g), b in self._buckets.items()}


@dataclasses.dataclass
class RetryPolicy:
    """Bounded retry with seeded jittered backoff, transient faults only."""

    max_retries: int = 2
    base_backoff_s: float = 0.002
    max_backoff_s: float = 0.05
    seed: int = 0

    def __post_init__(self):
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()

    @staticmethod
    def is_transient(e: BaseException) -> bool:
        return bool(getattr(e, "transient", False))

    def backoff_s(self, attempt: int) -> float:
        base = min(self.max_backoff_s,
                   self.base_backoff_s * (2 ** max(attempt - 1, 0)))
        with self._lock:
            return base * (0.5 + self._rng.random())


class _Breaker:
    __slots__ = ("state", "fails", "opened_at", "half_open_inflight")

    def __init__(self):
        self.state = CLOSED
        self.fails = 0
        self.opened_at = 0.0
        self.half_open_inflight = False


class BreakerBoard:
    """Per-``(algorithm, scheme)`` circuit breakers.

    CLOSED counts consecutive transient failures; at ``threshold`` the
    breaker OPENs (the service routes that plan variant to the NumPy
    reference path).  After ``cooldown_s`` the next query is a HALF_OPEN
    trial on the real kernels: success closes, failure re-opens.  Every
    transition lands as a ``breaker_state`` gauge + structured event +
    flight-recorder entry.
    """

    def __init__(self, *, threshold: int = 3, cooldown_s: float = 30.0,
                 clock=time.monotonic, metrics=None, flight=None):
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self.metrics = metrics
        self.flight = flight
        self._lock = threading.Lock()
        self._breakers: dict[tuple[str, str], _Breaker] = {}

    def _emit(self, key: tuple[str, str], b: _Breaker, why: str) -> None:
        phase, scheme = key
        if self.metrics is not None:
            self.metrics.set_gauge("breaker_state", float(b.state),
                                   phase=phase, scheme=scheme)
            self.metrics.event("breaker", phase=phase, scheme=scheme,
                               state=_STATE_NAMES[b.state], why=why)
        if self.flight is not None:
            self.flight.record_resilience(
                "breaker", phase=phase, scheme=scheme,
                state=_STATE_NAMES[b.state], why=why)

    def allow(self, key: tuple[str, str]) -> bool:
        """May this plan variant run on the real kernels right now?
        ``False`` = quarantined (route to the reference path)."""
        with self._lock:
            b = self._breakers.get(key)
            if b is None or b.state == CLOSED:
                return True
            if b.state == OPEN:
                if self._clock() - b.opened_at >= self.cooldown_s:
                    b.state = HALF_OPEN
                    b.half_open_inflight = True
                    self._emit(key, b, "cooldown_elapsed")
                    return True
                return False
            # HALF_OPEN: exactly one in-flight trial at a time.
            if b.half_open_inflight:
                return False
            b.half_open_inflight = True
            return True

    def record_failure(self, key: tuple[str, str]) -> bool:
        """One transient failure of the variant; True when it (re)opened."""
        with self._lock:
            b = self._breakers.setdefault(key, _Breaker())
            if b.state == HALF_OPEN:
                b.state = OPEN
                b.opened_at = self._clock()
                b.half_open_inflight = False
                self._emit(key, b, "half_open_trial_failed")
                return True
            b.fails += 1
            if b.state == CLOSED and b.fails >= self.threshold:
                b.state = OPEN
                b.opened_at = self._clock()
                self._emit(key, b, "failure_threshold")
                return True
            return False

    def record_success(self, key: tuple[str, str]) -> None:
        with self._lock:
            b = self._breakers.get(key)
            if b is None:
                return
            if b.state == HALF_OPEN:
                b.state = CLOSED
                b.fails = 0
                b.half_open_inflight = False
                self._emit(key, b, "half_open_trial_ok")
            elif b.state == CLOSED:
                b.fails = 0

    def release(self, key: tuple[str, str]) -> None:
        """A half-open trial ended without a verdict (preempted /
        cancelled): free the trial slot without a state transition."""
        with self._lock:
            b = self._breakers.get(key)
            if b is not None and b.state == HALF_OPEN:
                b.half_open_inflight = False

    def state_of(self, key: tuple[str, str]) -> int:
        with self._lock:
            b = self._breakers.get(key)
            return CLOSED if b is None else b.state

    def summary(self) -> dict:
        with self._lock:
            return {f"{p}/{s}": {"state": _STATE_NAMES[b.state],
                                 "fails": b.fails}
                    for (p, s), b in self._breakers.items()}
