"""SLO burn-rate monitoring over the engine's per-tenant counters.

A copy of ``repro/obs/slo.py`` (no framework imports).

An :class:`SLObjective` states a target success ratio over a pair of
counters — e.g. *deadline*: ``deadline_hits`` good / ``deadline_misses``
bad, target 0.75 — leaving an **error budget** of ``1 - target``.  The
**burn rate** over a window is how fast that budget is being consumed:

    burn = windowed_error_rate / error_budget

(burn 1.0 = exactly on budget; 2.0 = spending it twice as fast as the
objective allows).  Following the multi-window alerting idiom, an alert
fires only when the burn exceeds ``burn_threshold`` in *both* a fast and
a slow window — the fast window gives detection latency, the slow one
suppresses blips — and only once at least ``min_events`` landed in the
window (tiny denominators make infinite-looking burns out of one miss).

The monitor is fed from the ``MetricsRegistry`` the service already
maintains: :meth:`SLOMonitor.evaluate` samples the cumulative per-tenant
counters into a timestamped history and differences them against the
window edges, so it needs no second event stream.  Each tenant is
evaluated separately plus an aggregate pseudo-tenant ``"*"`` (small
smoke runs rarely give one tenant ``min_events`` alone).  On an alert
*transition* it bumps ``slo_alerts_total``, appends a structured
``slo`` event to the registry and an ``slo_alert`` instant to the
tracer; :meth:`summary` (registered as the ``"slo"`` collector) carries
the active alerts into every ``stats()`` snapshot.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque


@dataclasses.dataclass(frozen=True)
class SLObjective:
    """One objective over a good/bad counter pair."""

    name: str                      # e.g. "deadline", "shed"
    good: str                      # counter name of successes
    bad: str                       # counter name of failures
    target: float                  # objective on good/(good+bad)
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    burn_threshold: float = 2.0
    min_events: int = 8

    @property
    def error_budget(self) -> float:
        return max(1e-9, 1.0 - float(self.target))


def default_objectives() -> tuple[SLObjective, ...]:
    """The service's stock objectives: per-tenant deadline hits and shed
    rate.  Targets are deliberately loose — the monitor exists to flag
    *storms* (burn >= 2x budget), not percentage drift."""
    return (
        SLObjective("deadline", good="deadline_hits",
                    bad="deadline_misses", target=0.75),
        SLObjective("shed", good="admitted", bad="shed", target=0.95),
    )


class SLOMonitor:
    """Multi-window burn-rate evaluation over registry counters."""

    def __init__(self, metrics, objectives=None, *,
                 clock=time.monotonic, tracer=None,
                 min_interval_s: float = 0.25, max_history: int = 4096):
        self.metrics = metrics
        self.objectives = tuple(objectives if objectives is not None
                                else default_objectives())
        self.tracer = tracer
        self._clock = clock
        self.min_interval_s = float(min_interval_s)
        self._lock = threading.Lock()
        # History: (t, {objective: {tenant: (good, bad)}}) cumulative
        # samples; bounded, oldest dropped (windows larger than the
        # retained span degrade to since-oldest deltas).
        self._history: deque = deque(maxlen=int(max_history))
        self._active: dict[tuple, dict] = {}
        self._last_eval_t: float | None = None
        self.evaluations = 0
        self.alerts_total = 0

    # -- sampling ------------------------------------------------------------
    def _sample(self) -> dict:
        out: dict = {}
        for obj in self.objectives:
            goods = self._per_tenant(obj.good)
            bads = self._per_tenant(obj.bad)
            tenants = set(goods) | set(bads)
            per = {t: (goods.get(t, 0.0), bads.get(t, 0.0))
                   for t in tenants}
            per["*"] = (sum(goods.values()), sum(bads.values()))
            out[obj.name] = per
        return out

    def _per_tenant(self, counter: str) -> dict[str, float]:
        out: dict[str, float] = {}
        for labels, v in self.metrics.counter_series(counter).items():
            tenant = dict(labels).get("tenant")
            if tenant is not None:
                out[tenant] = out.get(tenant, 0.0) + v
        return out

    def _baseline(self, now: float, window_s: float):
        """The newest sample at/before ``now - window_s`` (a sample aged
        exactly to the window edge IS the baseline), else the oldest
        retained sample (partial window: deltas since monitoring began)."""
        edge = now - window_s
        base = None
        for t, sample in self._history:
            if t <= edge:
                base = sample
            else:
                break
        if base is None and self._history:
            base = self._history[0][1]
        return base

    @staticmethod
    def _window_rate(cur: tuple, base: tuple | None
                     ) -> tuple[float, float]:
        """(error_rate, events) between a baseline and current sample."""
        bg, bb = base if base is not None else (0.0, 0.0)
        d_good = max(0.0, cur[0] - bg)
        d_bad = max(0.0, cur[1] - bb)
        total = d_good + d_bad
        if total <= 0:
            return 0.0, 0.0
        return d_bad / total, total

    # -- evaluation ----------------------------------------------------------
    def evaluate(self, force: bool = False) -> list[dict]:
        """Sample the counters, update burn rates, fire/clear alerts.
        Returns the currently-active alerts.  Throttled to
        ``min_interval_s`` unless ``force``."""
        now = self._clock()
        with self._lock:
            if (not force and self._last_eval_t is not None
                    and now - self._last_eval_t < self.min_interval_s):
                return [dict(a) for a in self._active.values()]
            self._last_eval_t = now
        sample = self._sample()
        fired, cleared = [], []
        with self._lock:
            self._history.append((now, sample))
            self.evaluations += 1
            base_of = {}
            for obj in self.objectives:
                for win in (obj.fast_window_s, obj.slow_window_s):
                    if win not in base_of:
                        base_of[win] = self._baseline(now, win)
            for obj in self.objectives:
                for tenant, cur in sample[obj.name].items():
                    burns, events = {}, {}
                    for tag, win in (("fast", obj.fast_window_s),
                                     ("slow", obj.slow_window_s)):
                        base = base_of[win]
                        bt = (base or {}).get(obj.name, {}).get(tenant) \
                            if base else None
                        rate, n = self._window_rate(cur, bt)
                        burns[tag] = rate / obj.error_budget
                        events[tag] = n
                    firing = (burns["fast"] >= obj.burn_threshold
                              and burns["slow"] >= obj.burn_threshold
                              and events["fast"] >= obj.min_events)
                    key = (obj.name, tenant)
                    if firing and key not in self._active:
                        alert = {"objective": obj.name, "tenant": tenant,
                                 "burn_fast": round(burns["fast"], 3),
                                 "burn_slow": round(burns["slow"], 3),
                                 "events_fast": events["fast"],
                                 "threshold": obj.burn_threshold,
                                 "since_t": now}
                        self._active[key] = alert
                        self.alerts_total += 1
                        fired.append(alert)
                    elif not firing and key in self._active:
                        cleared.append(self._active.pop(key))
                    elif firing:
                        a = self._active[key]
                        a["burn_fast"] = round(burns["fast"], 3)
                        a["burn_slow"] = round(burns["slow"], 3)
            active = [dict(a) for a in self._active.values()]
        # Transitions emit outside the monitor lock (registry is a leaf
        # lock; tracer takes its own).
        for alert in fired:
            self.metrics.inc("slo_alerts_total",
                             objective=alert["objective"],
                             tenant=alert["tenant"])
            self.metrics.event("slo", action="fire", **alert)
            if self.tracer is not None:
                self.tracer.instant("slo_alert",
                                    objective=alert["objective"],
                                    slo_tenant=alert["tenant"],
                                    burn=alert["burn_fast"])
        for alert in cleared:
            self.metrics.event("slo", action="resolve",
                               objective=alert["objective"],
                               tenant=alert["tenant"])
        return active

    def alerts(self) -> list[dict]:
        with self._lock:
            return [dict(a) for a in self._active.values()]

    def summary(self) -> dict:
        """Registry-collector view: objectives, active alerts, totals."""
        with self._lock:
            return {"objectives": [
                        {"name": o.name, "target": o.target,
                         "fast_window_s": o.fast_window_s,
                         "slow_window_s": o.slow_window_s,
                         "burn_threshold": o.burn_threshold}
                        for o in self.objectives],
                    "active": [dict(a) for a in self._active.values()],
                    "alerts_total": self.alerts_total,
                    "evaluations": self.evaluations}
