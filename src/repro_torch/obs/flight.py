"""Flight recorder: a bounded ring of recent query lifecycles that dumps
itself when things go wrong.

A copy of ``repro/obs/flight.py`` (no framework imports).

Traces and metrics answer "what is happening"; the flight recorder
answers "what *was* happening just before it broke".  It keeps an
always-on, bounded ring of compact per-query records — outcome summary,
plan signature, admission decisions, failures — plus per-tenant
sub-rings, and produces a post-mortem JSON bundle (:meth:`dump`)
automatically on:

  * a **query failure** (any execution exception),
  * a **shed storm** (``storm_n`` sheds/rejects inside
    ``storm_window_s``),
  * a **deadline-miss burst** (``burst_n`` misses inside
    ``burst_window_s``).

Auto-dumps are rate-limited (``min_dump_gap_s``) and land either on disk
(``dump_dir`` set: ``FLIGHT_<name>_<stamp>_<n>_<reason>.json``, the
prefix keeping them out of ``check_regression``'s ``BENCH_*`` glob while
CI uploads them next to the rollups) or in the in-memory ``auto_dumps``
ring.
Every live recorder self-registers in a module-level weak set so the
bench harness can dump *all* of them when a bench run fails
(:func:`dump_live_recorders`).

Records are plain dicts built by :func:`summarize_outcome` — a span
digest distilled from ``Timing.phase_s`` rather than the full trace, so
the recorder works (and stays cheap) even under ``NULL_TRACER``.
"""
from __future__ import annotations

import json
import os
import threading
import time
import weakref
from collections import deque

#: Schema tag stamped into every dump (consumers validate against it).
SCHEMA = "flight-recorder/v1"

_LIVE: "weakref.WeakSet[FlightRecorder]" = weakref.WeakSet()


def summarize_outcome(outcome) -> dict:
    """Compact lifecycle record for one ``QueryOutcome`` (duck-typed so
    the recorder has no dependency on engine types)."""
    plan = outcome.plan
    timing = outcome.timing
    phases = {k: round(float(v), 6)
              for k, v in getattr(timing, "phase_s", {}).items()}
    return {
        "kind": "outcome",
        "query_id": outcome.query_id, "tag": outcome.tag,
        "tenant": outcome.tenant,
        "algorithm": getattr(plan, "algorithm", None),
        "scheme": getattr(plan, "scheme", None),
        "join_kind": getattr(plan, "kind", None),
        "schedule": (list(plan.schedule)
                     if getattr(plan, "schedule", None) else None),
        "est_s": round(float(getattr(plan, "est_s", 0.0)), 6),
        "queued_s": round(float(outcome.queued_s), 6),
        "wall_s": round(float(outcome.wall_s), 6),
        "deadline_hit": outcome.deadline_hit,
        "degraded": outcome.degraded,
        "cache_hit": outcome.cache_hit,
        "phases": phases,
    }


class FlightRecorder:
    """Always-on bounded recorder of recent query lifecycles."""

    def __init__(self, *, capacity: int = 512, tenant_capacity: int = 128,
                 clock=time.monotonic, name: str = "service",
                 storm_n: int = 8, storm_window_s: float = 5.0,
                 burst_n: int = 8, burst_window_s: float = 5.0,
                 min_dump_gap_s: float = 30.0,
                 dump_dir: str | None = None):
        self.name = name
        self.dump_dir = dump_dir
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=int(capacity))
        self._tenant_cap = int(tenant_capacity)
        self._tenants: dict[str, deque] = {}
        self._counts = {"outcome": 0, "admission": 0, "failure": 0}
        # Trigger state: timestamps of recent sheds / deadline misses.
        self.storm_n, self.storm_window_s = int(storm_n), float(storm_window_s)
        self.burst_n, self.burst_window_s = int(burst_n), float(burst_window_s)
        self.min_dump_gap_s = float(min_dump_gap_s)
        self._sheds: deque = deque(maxlen=max(self.storm_n, 1))
        self._misses: deque = deque(maxlen=max(self.burst_n, 1))
        self._last_dump_t: float | None = None
        self.dump_count = 0
        #: In-memory auto-dumps when no ``dump_dir`` is configured.
        self.auto_dumps: deque = deque(maxlen=4)
        #: Paths of dumps written to disk (auto or explicit).
        self.dump_paths: list[str] = []
        _LIVE.add(self)

    # -- recording -----------------------------------------------------------
    def _append(self, rec: dict) -> None:
        t = self._clock()
        rec = {"t": round(float(t), 6), **rec}
        with self._lock:
            self._ring.append(rec)
            self._counts[rec["kind"]] = self._counts.get(rec["kind"], 0) + 1
            tenant = rec.get("tenant")
            if tenant is not None:
                ring = self._tenants.get(tenant)
                if ring is None:
                    ring = self._tenants[tenant] = deque(
                        maxlen=self._tenant_cap)
                ring.append(rec)

    def record_outcome(self, outcome) -> None:
        rec = summarize_outcome(outcome)
        self._append(rec)
        if rec.get("deadline_hit") is False:
            self._bump_trigger(self._misses, self.burst_n,
                               self.burst_window_s, "deadline_miss_burst")

    def record_admission(self, action: str, **payload) -> None:
        """One shed/reject/degrade decision (mirrors the registry event)."""
        self._append({"kind": "admission", "action": action, **payload})
        if action in ("shed", "reject"):
            self._bump_trigger(self._sheds, self.storm_n,
                               self.storm_window_s, "shed_storm")

    def record_failure(self, *, tenant: str = "default", query_id: int = -1,
                       where: str = "execute", error: str = "") -> None:
        """One execution failure — always triggers a dump (rate-limited)."""
        self._append({"kind": "failure", "tenant": tenant,
                      "query_id": query_id, "where": where,
                      "error": error[:500]})
        self._maybe_dump("query_failure")

    def record_resilience(self, what: str, **payload) -> None:
        """One recovery-ladder transition (preemption, retry, degrade
        fallback, breaker state change, worker restart, checkpoint) —
        recorded, never a dump trigger by itself: the ladder *handling*
        a fault is normal operation, only unhandled failures dump."""
        self._append({"kind": "resilience", "what": what, **payload})

    def _bump_trigger(self, ring: deque, n: int, window_s: float,
                      reason: str) -> None:
        now = self._clock()
        with self._lock:
            ring.append(now)
            fired = (len(ring) >= n and now - ring[0] <= window_s)
        if fired:
            self._maybe_dump(reason)

    # -- dumping -------------------------------------------------------------
    def _maybe_dump(self, reason: str) -> None:
        now = self._clock()
        with self._lock:
            if (self._last_dump_t is not None
                    and now - self._last_dump_t < self.min_dump_gap_s):
                return
            self._last_dump_t = now
        bundle = self.dump(reason)
        if self.dump_dir:
            try:
                self._write(bundle)
            except OSError:
                self.auto_dumps.append(bundle)
        else:
            self.auto_dumps.append(bundle)

    def dump(self, reason: str = "manual") -> dict:
        """The post-mortem bundle: everything currently in the rings."""
        with self._lock:
            records = list(self._ring)
            tenants = {t: list(r) for t, r in self._tenants.items()}
            counts = dict(self._counts)
            self.dump_count += 1
        return {"schema": SCHEMA, "reason": reason, "name": self.name,
                "t": round(float(self._clock()), 6),
                "counts": counts, "records": records, "tenants": tenants}

    def _write(self, bundle: dict) -> str:
        import datetime
        stamp = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y%m%dT%H%M%SZ")
        os.makedirs(self.dump_dir, exist_ok=True)
        reason = "".join(c if c.isalnum() else "-" for c in bundle["reason"])
        # dump_count disambiguates dumps landing in the same second
        # (e.g. a shed storm with the cooldown disabled).
        path = os.path.join(
            self.dump_dir,
            f"FLIGHT_{self.name}_{stamp}_{self.dump_count:03d}_"
            f"{reason}.json")
        with open(path, "w") as f:
            json.dump(bundle, f, indent=1, default=float)
        self.dump_paths.append(path)
        return path

    def write_dump(self, path: str, reason: str = "manual") -> str:
        """Write one explicit dump to ``path`` (benches: the overload-run
        artifact the regression gate validates)."""
        bundle = self.dump(reason)
        with open(path, "w") as f:
            json.dump(bundle, f, indent=1, default=float)
        self.dump_paths.append(path)
        return path

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def summary(self) -> dict:
        """Registry-collector view: ring occupancy + trigger counters."""
        with self._lock:
            return {"records": len(self._ring),
                    "tenants": {t: len(r) for t, r in self._tenants.items()},
                    "counts": dict(self._counts),
                    "dumps": self.dump_count,
                    "auto_dumps": len(self.auto_dumps)
                    + len(self.dump_paths)}


def validate_dump(bundle: dict) -> bool:
    """Schema check for a flight dump (the regression gate's validator)."""
    return (isinstance(bundle, dict)
            and bundle.get("schema") == SCHEMA
            and isinstance(bundle.get("records"), list)
            and isinstance(bundle.get("tenants"), dict)
            and isinstance(bundle.get("counts"), dict)
            and isinstance(bundle.get("reason"), str))


def dump_live_recorders(dump_dir: str, reason: str = "bench_failure"
                        ) -> list[str]:
    """Dump every live, non-empty recorder to ``dump_dir`` — the bench
    harness calls this when a bench step fails so CI uploads the recent
    query lifecycles next to the ``BENCH_*.json`` rollup."""
    paths = []
    for rec in list(_LIVE):
        if len(rec) == 0:
            continue
        prev = rec.dump_dir
        rec.dump_dir = dump_dir
        try:
            paths.append(rec._write(rec.dump(reason)))
        except OSError:
            pass
        finally:
            rec.dump_dir = prev
    return paths
