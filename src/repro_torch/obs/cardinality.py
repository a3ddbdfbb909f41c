"""Cardinality audit: System-R estimates vs exact device-observed rows.

A copy of ``repro/obs/cardinality.py`` (no framework imports).

The executor already computes every stage's exact output cardinality
on-device (``_match_stats_jit`` counts matches before any gather), yet
until now that number was used only to size buffers — the optimizer's
System-R estimates were never confronted with it.  This audit records
the pair for every executed stage and summarizes the **q-error**

    q = max(est / actual, actual / est)    (rows clamped to >= 1)

the standard symmetric measure from the adaptive-query-processing
literature: 1.0 is a perfect estimate, q >= 2 means the optimizer was
off by 2x in either direction.  Per stage-type / depth / tenant p50/p95
summaries surface through ``snapshot()["cardinality_error"]`` alongside
the time-domain ``prediction_error``, and the executor's adaptive
replan loop uses the same per-stage q-error as its trigger.
"""
from __future__ import annotations

import threading
from collections import deque

from .metrics import _percentile


def q_error(est_rows, observed_rows) -> float:
    """Symmetric multiplicative estimate error, clamped to rows >= 1."""
    e = max(1.0, float(est_rows))
    a = max(1.0, float(observed_rows))
    return max(e / a, a / e)


class CardinalityAudit:
    """Bounded ring of per-stage (estimated, observed) cardinality pairs."""

    def __init__(self, max_records: int = 8192):
        self._lock = threading.Lock()
        self._records: deque = deque(maxlen=int(max_records))

    @property
    def capacity(self) -> int:
        return int(self._records.maxlen or 0)

    def record(self, *, stage_type: str, est_rows: float, observed_rows: int,
               depth: int = 0, tenant: str = "default",
               stage_id: int = -1) -> float:
        """Append one executed stage's pair; returns its q-error.

        ``est_rows`` is the optimizer's ``est_out`` for the stage;
        ``observed_rows`` is the exact pre-residual match count the device
        reported.  Both are clamped to >= 1 for the ratio (an estimate of
        0.3 rows vs an observed 0 is a perfect prediction, not infinite
        error).
        """
        q = q_error(est_rows, observed_rows)
        with self._lock:
            self._records.append({
                "stage_type": str(stage_type), "depth": int(depth),
                "tenant": tenant, "stage_id": int(stage_id),
                "est_rows": float(est_rows),
                "observed_rows": int(observed_rows), "q_error": q})
        return q

    def records(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._records]

    def summary(self) -> dict:
        """Per stage-type / depth / tenant q-error summaries.

        Registered as the ``cardinality_error`` metrics collector; the CI
        gate requires every executed stage type to show a finite p50/p95.
        """
        with self._lock:
            recs = list(self._records)
        by_type: dict[str, list[float]] = {}
        by_depth: dict[str, list[float]] = {}
        by_tenant: dict[str, list[float]] = {}
        for r in recs:
            by_type.setdefault(r["stage_type"], []).append(r["q_error"])
            by_depth.setdefault(str(r["depth"]), []).append(r["q_error"])
            by_tenant.setdefault(r["tenant"], []).append(r["q_error"])

        def _summ(vals):
            s = sorted(vals)
            return {"count": len(s), "p50": _percentile(s, 0.50),
                    "p95": _percentile(s, 0.95), "max": s[-1]}

        return {"count": len(recs),
                "stage_types": {k: _summ(v)
                                for k, v in sorted(by_type.items())},
                "depths": {k: _summ(v) for k, v in sorted(by_depth.items())},
                "tenants": {k: _summ(v)
                            for k, v in sorted(by_tenant.items())}}

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
