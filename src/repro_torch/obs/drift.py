"""Cost-model drift detection over the audit trail — and what to do
about it.

A copy of ``repro/obs/drift.py`` (no framework imports).

The planner's estimates are only trustworthy while the measured-vs-
predicted ratio stays stationary; a workload shift (contention, cache
behaviour, data skew) shows up as a *sustained* move in
``log(measured_s / est_s)``.  :class:`DriftDetector` listens to every
``CostAudit`` record and runs a two-sided Page-Hinkley test per
``(phase, scheme)`` series: cheap (O(1) per sample), with an explicit
mean-shift magnitude (``delta``) below which wiggle is ignored and a
cumulative-deviation ``threshold`` that must accumulate before firing —
one outlier cannot trip it, a sustained shift must.

On a drift firing the detector **acts** (the closed loop this layer is
for):

  * bumps the ``cost_model_staleness`` gauge (global + per-series) and a
    ``cost_model_drift_events`` counter, emits a structured ``drift``
    event and a ``drift_alert`` trace instant;
  * invokes ``on_drift(phase, scheme, stats)`` — the service maps the
    phase to its algorithm and flags the affected sticky plans for
    re-pricing through ``QueryPlanner.flag_replan`` (the existing
    replan-hysteresis path, not a new one);
  * resets that series' test state so it can fire again on a later
    shift.

Independently, a rolling per-tenant ratio window prices a **safety
margin** — ``clamp(q75(ratio), 1.0, margin_cap)`` — pushed through
``on_margin(tenant, margin)`` into ``AdmissionController`` pricing, so
a tenant whose queries keep running 2x over estimate is admitted as if
its estimates were 2x larger (closing ROADMAP item 1's "prediction
error -> admission margin" remainder).
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque


class PageHinkley:
    """Two-sided Page-Hinkley test on a stream of (log-ratio) samples.

    Fires when the cumulative deviation from the running mean exceeds
    ``threshold`` in either direction after at least ``min_samples``.
    """

    def __init__(self, *, delta: float = 0.05, threshold: float = 0.5,
                 min_samples: int = 8):
        self.delta = float(delta)
        self.threshold = float(threshold)
        self.min_samples = int(min_samples)
        self.reset()

    def reset(self) -> None:
        self.n = 0
        self.mean = 0.0
        # Separate up/down accumulators: the +/- delta slack must lean
        # *against* each direction's statistic, or a stationary stream
        # drifts one of them across the threshold all by itself.
        self._up = 0.0         # cumulative (x - mean - delta)
        self._up_min = 0.0
        self._dn = 0.0         # cumulative (x - mean + delta)
        self._dn_max = 0.0

    def update(self, x: float) -> bool:
        """Feed one sample; True when a sustained shift is detected."""
        self.n += 1
        self.mean += (x - self.mean) / self.n
        self._up += x - self.mean - self.delta
        self._up_min = min(self._up_min, self._up)
        self._dn += x - self.mean + self.delta
        self._dn_max = max(self._dn_max, self._dn)
        if self.n < self.min_samples:
            return False
        return (self._up - self._up_min > self.threshold
                or self._dn_max - self._dn > self.threshold)


class DriftDetector:
    """Per-(phase, scheme) drift detection + per-tenant safety margins."""

    def __init__(self, *, metrics=None, tracer=None,
                 on_drift=None, on_margin=None,
                 delta: float = 0.05, threshold: float = 0.5,
                 min_samples: int = 8,
                 margin_quantile: float = 0.75, margin_cap: float = 4.0,
                 margin_window: int = 64, margin_min_samples: int = 8,
                 clock=time.monotonic):
        self.metrics = metrics
        self.tracer = tracer
        self.on_drift = on_drift
        self.on_margin = on_margin
        self.delta = float(delta)
        self.threshold = float(threshold)
        self.min_samples = int(min_samples)
        self.margin_quantile = float(margin_quantile)
        self.margin_cap = float(margin_cap)
        self.margin_window = int(margin_window)
        self.margin_min_samples = int(margin_min_samples)
        self._clock = clock
        self._lock = threading.Lock()
        self._ph: dict[tuple[str, str], PageHinkley] = {}
        self._ratios: dict[tuple[str, str], deque] = {}
        self._tenant_ratios: dict[str, deque] = {}
        self._margins: dict[str, float] = {}
        self.drift_events = 0
        self._stale_keys: set[tuple[str, str]] = set()
        if self.metrics is not None:
            # Pre-seed: the regression gate requires the staleness gauge
            # present and finite even when nothing ever drifted.
            self.metrics.set_gauge("cost_model_staleness", 0.0)

    # -- the audit listener --------------------------------------------------
    def observe_record(self, rec: dict) -> None:
        """One ``CostAudit`` record (the registered listener)."""
        ratio = rec.get("ratio")
        if ratio is None or not (ratio > 0.0) or not math.isfinite(ratio):
            return
        phase, scheme = rec.get("phase", "?"), rec.get("scheme", "?")
        tenant = rec.get("tenant", "default")
        x = math.log(ratio)
        fired_stats = None
        margin_update = None
        with self._lock:
            key = (phase, scheme)
            ph = self._ph.get(key)
            if ph is None:
                ph = self._ph[key] = PageHinkley(
                    delta=self.delta, threshold=self.threshold,
                    min_samples=self.min_samples)
            ring = self._ratios.setdefault(key, deque(maxlen=64))
            ring.append(float(ratio))
            if ph.update(x):
                self.drift_events += 1
                self._stale_keys.add(key)
                fired_stats = {"phase": phase, "scheme": scheme,
                               "mean_log_ratio": round(ph.mean, 4),
                               "mean_ratio": round(math.exp(ph.mean), 4),
                               "samples": ph.n,
                               "drift_events": self.drift_events}
                ph.reset()       # re-arm: a later shift can fire again
            tring = self._tenant_ratios.setdefault(
                tenant, deque(maxlen=self.margin_window))
            tring.append(float(ratio))
            if len(tring) >= self.margin_min_samples:
                margin = self._price_margin(tring)
                if abs(margin - self._margins.get(tenant, 1.0)) > 1e-3:
                    self._margins[tenant] = margin
                    margin_update = (tenant, margin)
        # Emissions happen outside the detector lock (registry is a leaf
        # lock; callbacks reach into planner/admission).
        if fired_stats is not None:
            self._emit_drift(fired_stats)
        if margin_update is not None:
            tenant, margin = margin_update
            if self.metrics is not None:
                self.metrics.set_gauge("admission_margin", margin,
                                       tenant=tenant)
            if self.on_margin is not None:
                self.on_margin(tenant, margin)

    def _price_margin(self, ratios: deque) -> float:
        s = sorted(ratios)
        idx = min(len(s) - 1,
                  max(0, int(round(self.margin_quantile * (len(s) - 1)))))
        return max(1.0, min(self.margin_cap, float(s[idx])))

    def _emit_drift(self, stats: dict) -> None:
        if self.metrics is not None:
            self.metrics.inc("cost_model_drift_events",
                             phase=stats["phase"], scheme=stats["scheme"])
            self.metrics.set_gauge("cost_model_staleness",
                                   float(len(self._stale_keys)))
            self.metrics.set_gauge("cost_model_staleness", 1.0,
                                   phase=stats["phase"],
                                   scheme=stats["scheme"])
            self.metrics.event("drift", **stats)
        if self.tracer is not None:
            self.tracer.instant("drift_alert", phase=stats["phase"],
                                drift_scheme=stats["scheme"],
                                mean_ratio=stats["mean_ratio"])
        if self.on_drift is not None:
            try:
                self.on_drift(stats["phase"], stats["scheme"], stats)
            except Exception:
                pass

    def mark_repriced(self, phase: str, scheme: str) -> None:
        """Clear a series' staleness after its plans were re-priced."""
        with self._lock:
            self._stale_keys.discard((phase, scheme))
            stale = float(len(self._stale_keys))
        if self.metrics is not None:
            self.metrics.set_gauge("cost_model_staleness", stale)
            self.metrics.set_gauge("cost_model_staleness", 0.0,
                                   phase=phase, scheme=scheme)

    def margin_of(self, tenant: str) -> float:
        with self._lock:
            return self._margins.get(tenant, 1.0)

    def summary(self) -> dict:
        """Registry-collector view: per-series state + tenant margins."""
        with self._lock:
            series = {}
            for (phase, scheme), ph in self._ph.items():
                ring = self._ratios.get((phase, scheme), ())
                n = len(ring)
                mean_ratio = (sum(ring) / n) if n else 1.0
                series[f"{phase}/{scheme}"] = {
                    "samples": ph.n, "window": n,
                    "mean_ratio": round(mean_ratio, 4),
                    "stale": (phase, scheme) in self._stale_keys}
            return {"series": series,
                    "margins": dict(self._margins),
                    "drift_events": self.drift_events,
                    "stale_series": len(self._stale_keys)}
