"""Predicted-vs-measured cost-model audit trail.

A copy of ``repro/obs/audit.py`` (no framework imports).

Every *executed* plan — not just the warmed/solo samples that feed the
online calibration — records its ``(phase, scheme, est_s, measured_s)``
pairs here.  That difference is the point: the planner's estimates are
solo-time predictions, and the audit's error ratios measure how wrong
they were *under contention*, which is exactly the signal ROADMAP item 1
needs for a per-tenant admission safety margin.

``summary()`` derives per-phase and per-tenant prediction-error ratios
(``measured_s / est_s``; p50/p95 over a bounded window) and is designed
to be registered as a ``MetricsRegistry`` collector, so the whole trail
surfaces through ``metrics.snapshot()["prediction_error"]``.
"""
from __future__ import annotations

import threading
from collections import deque

from .metrics import _percentile


class CostAudit:
    """Bounded ring of per-phase audit records with ratio summaries."""

    def __init__(self, max_records: int = 8192):
        self._lock = threading.Lock()
        self._records: deque = deque(maxlen=int(max_records))
        # Record listeners (e.g. the drift detector): invoked once per
        # appended record, outside the audit lock — a listener may call
        # back into components that themselves log metrics.
        self._listeners: list = []

    @property
    def capacity(self) -> int:
        """The retention bound (ring ``maxlen``) — long-running services
        cannot grow audit memory past it; exposed as a service gauge."""
        return int(self._records.maxlen or 0)

    def add_listener(self, fn) -> None:
        """Register ``fn(record_dict)`` to observe every appended record."""
        self._listeners.append(fn)

    def record(self, pairs, *, tenant: str = "default",
               query_id: int = -1) -> None:
        """Append one executed plan's phase pairs.

        ``pairs`` is ``[(phase, scheme, est_s, measured_s), ...]`` —
        produced by ``QueryPlanner.phase_pairs`` from the *executed* plan
        object and its measured ``Timing``, never from admission-time
        re-pricing.  Pairs with a non-positive estimate carry no ratio
        (they cannot be audited) but are still recorded.
        """
        recs = []
        for phase, scheme, est_s, measured_s in pairs:
            est_s = float(est_s)
            measured_s = float(measured_s)
            ratio = (measured_s / est_s) if est_s > 0.0 else None
            recs.append({"phase": phase, "scheme": scheme,
                         "est_s": est_s, "measured_s": measured_s,
                         "ratio": ratio, "tenant": tenant,
                         "query_id": query_id})
        with self._lock:
            self._records.extend(recs)
        for fn in self._listeners:
            for r in recs:
                try:
                    fn(r)
                except Exception:   # a broken listener must not sink queries
                    pass

    def records(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._records]

    def summary(self) -> dict:
        """Per-phase and per-tenant prediction-error ratio summaries.

        ``ratio = measured_s / est_s`` (1.0 = perfect prediction; > 1
        under-estimated, e.g. contention inflating solo-time estimates).
        """
        with self._lock:
            recs = list(self._records)
        by_phase: dict[str, list[float]] = {}
        by_tenant: dict[str, list[float]] = {}
        for r in recs:
            if r["ratio"] is None:
                continue
            by_phase.setdefault(r["phase"], []).append(r["ratio"])
            by_tenant.setdefault(r["tenant"], []).append(r["ratio"])

        def _summ(vals):
            s = sorted(vals)
            return {"count": len(s), "p50": _percentile(s, 0.50),
                    "p95": _percentile(s, 0.95)}

        return {"count": len(recs),
                "phases": {k: _summ(v) for k, v in sorted(by_phase.items())},
                "tenants": {k: _summ(v)
                            for k, v in sorted(by_tenant.items())}}

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
