"""Labeled counters/gauges/histograms with lock-safe snapshots.

A copy of ``repro/obs/metrics.py`` (no framework imports).

One registry per service absorbs the engine's formerly scattered
counters (``host_bytes_moved``, shed/degraded/rejected, cache hits,
calibration version ticks) behind a single :meth:`MetricsRegistry.snapshot`.

Design rules:

  * Series are keyed by ``(name, sorted labels)``.  The snapshot is a
    flat dict: an unlabeled series (or the sum over a name's labeled
    series) appears under the plain ``name`` — so
    ``snapshot()["host_bytes_moved"]`` is an int — and each labeled
    series additionally appears under ``name{k=v,...}``.
  * **Lock ordering:** the registry lock is a *leaf* lock.  Components
    must never call into the registry while holding their own locks;
    conversely :meth:`snapshot` reads all native series atomically under
    the registry lock, then invokes registered *collectors* (which take
    their components' locks) outside it — one consistent pass, no
    lock-order cycle.
  * *Events* are bounded structured records (dicts) for decisions that
    matter individually — admission shed/degrade — so consumers (e.g.
    ``slo_bench``) read them from the registry instead of re-deriving
    them from raised exceptions.
"""
from __future__ import annotations

import threading
import time
from collections import deque


def _percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return float(sorted_vals[idx])


class MetricsRegistry:
    """Thread-safe registry of counters, gauges, histograms, events and
    collectors."""

    def __init__(self, *, max_events: int = 4096,
                 histogram_window: int = 4096,
                 histogram_window_s: float | None = None,
                 clock=time.monotonic):
        self._lock = threading.Lock()
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        self._hists: dict[tuple, deque] = {}
        self._events: deque = deque(maxlen=int(max_events))
        self._hist_window = int(histogram_window)
        # Optional *time* window on top of the count bound: a sample whose
        # age reaches the window is gone — strictly older-than keeps, so a
        # sample lands exactly at the edge ages out (see test_obs_loop).
        self._hist_window_s = (None if histogram_window_s is None
                               else float(histogram_window_s))
        self._clock = clock
        self._collectors: dict[str, object] = {}

    @staticmethod
    def _key(name: str, labels: dict) -> tuple:
        return (name, tuple(sorted(labels.items())))

    @staticmethod
    def _flat(name: str, label_items: tuple) -> str:
        inner = ",".join(f"{k}={v}" for k, v in label_items)
        return f"{name}{{{inner}}}"

    # -- writers -------------------------------------------------------------
    def inc(self, name: str, value: float = 1, **labels) -> None:
        """Increment a (possibly labeled) counter."""
        key = self._key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        key = self._key(name, labels)
        with self._lock:
            self._gauges[key] = value

    def observe(self, name: str, value: float, **labels) -> None:
        """Record one histogram sample (sliding window, per series).

        Samples are stamped with the registry clock; when a time window is
        configured (``histogram_window_s``) aged-out samples are pruned
        here and excluded from summaries.
        """
        key = self._key(name, labels)
        now = self._clock()
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = deque(maxlen=self._hist_window)
            h.append((now, float(value)))
            self._prune_locked(h, now)

    def _prune_locked(self, h: deque, now: float) -> None:
        if self._hist_window_s is None:
            return
        edge = now - self._hist_window_s
        while h and h[0][0] <= edge:
            h.popleft()

    def _hist_values(self, samples, now: float) -> list[float]:
        """Window-filtered sample values (edge-exclusive on the old side)."""
        if self._hist_window_s is None:
            return [v for _, v in samples]
        edge = now - self._hist_window_s
        return [v for t, v in samples if t > edge]

    def histogram_summary(self, name: str, **labels) -> dict:
        """Point-in-time summary of one histogram series (an empty or
        fully-aged-out window reads as count=0 with zeroed stats)."""
        key = self._key(name, labels)
        now = self._clock()
        with self._lock:
            samples = list(self._hists.get(key, ()))
        return self._hist_summary(self._hist_values(samples, now))

    def event(self, name: str, **payload) -> None:
        """Append a structured event record (bounded ring)."""
        with self._lock:
            self._events.append({"event": name, **payload})

    # -- readers -------------------------------------------------------------
    def counter_value(self, name: str) -> float:
        """Sum of a counter's series across labels (cheap: no collectors
        run — unlike :meth:`snapshot`)."""
        with self._lock:
            return sum(v for (n, _), v in self._counters.items()
                       if n == name)

    def counter_series(self, name: str) -> dict[tuple, float]:
        """All of one counter's labeled series: ``{label-items: value}``
        (label items are the sorted ``(key, value)`` tuples).  The cheap
        read the SLO monitor samples per-tenant counters through."""
        with self._lock:
            return {labels: v for (n, labels), v in self._counters.items()
                    if n == name}

    def events(self, name: str | None = None) -> list[dict]:
        with self._lock:
            evs = list(self._events)
        if name is None:
            return evs
        return [e for e in evs if e.get("event") == name]

    def register_collector(self, name: str, fn) -> None:
        """Register ``fn() -> value`` to be materialized under ``name``
        in every snapshot.  Collectors run *outside* the registry lock
        (they may take their own component locks); registering the same
        name again replaces the previous collector."""
        with self._lock:
            self._collectors[name] = fn

    @staticmethod
    def _hist_summary(vals) -> dict:
        s = sorted(vals)
        n = len(s)
        return {"count": n, "sum": float(sum(s)),
                "min": (s[0] if n else 0.0), "max": (s[-1] if n else 0.0),
                "p50": _percentile(s, 0.50), "p95": _percentile(s, 0.95)}

    def snapshot(self) -> dict:
        """One consistent point-in-time view.

        All native series are read atomically under the registry lock;
        collectors (queue depth, cache stats, planner stats, audit
        summaries) are then invoked immediately after in the same pass.
        """
        now = self._clock()
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: self._hist_values(v, now)
                     for k, v in self._hists.items()}
            collectors = list(self._collectors.items())
        out: dict = {}
        totals: dict[str, float] = {}
        for (name, labels), v in counters.items():
            totals[name] = totals.get(name, 0) + v
            if labels:
                out[self._flat(name, labels)] = v
        for name, v in totals.items():
            out[name] = v
        for (name, labels), v in gauges.items():
            out[self._flat(name, labels) if labels else name] = v
        for (name, labels), vals in hists.items():
            key = self._flat(name, labels) if labels else name
            out[key] = self._hist_summary(vals)
        for name, fn in collectors:
            try:
                out[name] = fn()
            except Exception:   # a broken collector must not sink stats()
                out[name] = None
        return out
