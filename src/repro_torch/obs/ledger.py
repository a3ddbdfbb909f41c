"""Host-transfer ledger: every H2D/D2H byte attributed to its cause.

A copy of ``repro/obs/ledger.py`` (no framework imports).

The coupled-architecture papers this repo reproduces agree on one thing:
the host boundary is the decisive cost.  The fused data path is
provably quiet (``host_bytes_moved == 0``, CI-gated), but that counter is
flat — when it reads non-zero nobody can say *which* stage, column, or
mechanism moved the bytes.  The ledger fixes that: every crossing is
recorded as ``(stage, column, cause, direction, nbytes)`` with a closed
cause taxonomy:

  * ``fingerprint``   — a build/probe key column pulled to host to compute
    a content fingerprint for the ``BuildTableCache`` (the structural
    fingerprints added alongside this ledger eliminate these on both
    pipeline paths; any residual pull — e.g. a raw device relation
    submitted straight to the engine — shows up here).
  * ``multicol_pack`` — multi-column group-by keys gathered to host for
    mixed-radix packing, and the packed key/value upload that follows
    (ROADMAP: device-side composite-key packing removes these next).
  * ``handoff``       — host-materialize stage hand-off traffic: rid
    vectors gathered down, materialized intermediates re-uploaded.  The
    fused path's defining invariant is that this cause stays 0.
  * ``result``        — final result delivery (``StageView.materialize``,
    scalar-sink column pulls).  Someone always reads the answer; these
    bytes are attributed but — as everywhere in this repo — *not*
    counted as intermediate traffic.

The port adds one cause of its own (``PORT_CAUSES``), reported by
``by_cause`` and ``summary`` once it has been recorded:

  * ``scan_upload``   — base-table columns a pipeline's scan views upload
    to the G group's device (``_ScanView.raw_chain``).  Every query reads
    its base tables; this is input, not intermediate traffic.

The flat ``host_bytes_moved`` counter is now a **sum view over the
ledger**: :meth:`TransferLedger.record` increments it for every
intermediate cause (``INTERMEDIATE_CAUSES``), so existing gates and
tests keep their exact semantics while gaining attribution underneath.
"""
from __future__ import annotations

import threading
from collections import deque

CAUSES = ("fingerprint", "multicol_pack", "handoff", "result")
#: Causes that count toward the service's ``host_bytes_moved`` counter.
#: ``result`` is excluded — final result delivery has never been counted
#: as intermediate traffic (the fused path's invariant).
INTERMEDIATE_CAUSES = ("fingerprint", "multicol_pack", "handoff")

#: The port's causes beyond the JAX package's taxonomy (not intermediate).
PORT_CAUSES = ("scan_upload",)

DIRECTIONS = ("h2d", "d2h")


class TransferLedger:
    """Thread-safe host-boundary byte ledger with bounded raw entries.

    Aggregates are exact and unbounded in *value* but bounded in *key
    count* by the workload's (stage, column, cause, direction) space;
    raw per-crossing entries live in a bounded ring for debugging.
    """

    def __init__(self, metrics=None, *, max_entries: int = 8192):
        self._lock = threading.Lock()
        self._metrics = metrics
        self._agg: dict[tuple, list] = {}   # key -> [bytes, count]
        self._entries: deque = deque(maxlen=int(max_entries))

    def record(self, nbytes, *, cause: str, stage: str = "-",
               column: str = "-", direction: str = "d2h",
               tenant: str = "default") -> None:
        """Attribute one host-boundary crossing.

        Increments the registry's ``host_bytes_moved`` for intermediate
        causes and the labeled ``host_transfer_bytes{cause,direction}``
        series for all causes — the flat counter is a sum view over the
        ledger by construction, never a separately-maintained number.
        """
        if cause not in CAUSES + PORT_CAUSES:
            raise ValueError(f"unknown transfer cause {cause!r} "
                             f"(want one of {CAUSES + PORT_CAUSES})")
        if direction not in DIRECTIONS:
            raise ValueError(f"unknown transfer direction {direction!r}")
        n = int(nbytes)
        if n <= 0:
            return
        key = (str(stage), str(column), cause, direction)
        with self._lock:
            slot = self._agg.get(key)
            if slot is None:
                self._agg[key] = [n, 1]
            else:
                slot[0] += n
                slot[1] += 1
            self._entries.append({"stage": key[0], "column": key[1],
                                  "cause": cause, "direction": direction,
                                  "nbytes": n, "tenant": tenant})
        if self._metrics is not None:    # registry lock is a leaf lock
            self._metrics.inc("host_transfer_bytes", n,
                              cause=cause, direction=direction)
            if cause in INTERMEDIATE_CAUSES:
                self._metrics.inc("host_bytes_moved", n)

    # -- readers -------------------------------------------------------------
    def total(self, *, intermediate_only: bool = True) -> int:
        """Sum over causes — with ``intermediate_only`` (the default) this
        equals the ``host_bytes_moved`` counter this ledger maintains."""
        with self._lock:
            return sum(b for (_, _, cause, _), (b, _) in self._agg.items()
                       if not intermediate_only
                       or cause in INTERMEDIATE_CAUSES)

    def by_cause(self) -> dict[str, int]:
        out = {c: 0 for c in CAUSES}
        with self._lock:
            for (_, _, cause, _), (b, _) in self._agg.items():
                out[cause] = out.get(cause, 0) + b
        return out

    def by_stage(self) -> dict[str, dict[str, int]]:
        """``{stage: {cause: bytes}}`` over all recorded crossings."""
        out: dict[str, dict[str, int]] = {}
        with self._lock:
            items = list(self._agg.items())
        for (stage, _, cause, _), (b, _) in items:
            out.setdefault(stage, {}).setdefault(cause, 0)
            out[stage][cause] += b
        return out

    def entries(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._entries]

    def summary(self) -> dict:
        """Snapshot for the ``host_transfer_ledger`` metrics collector."""
        with self._lock:
            items = list(self._agg.items())
        by_cause = {c: 0 for c in CAUSES}
        by_direction = {d: 0 for d in DIRECTIONS}
        crossings = 0
        for (_, _, cause, direction), (b, n) in items:
            by_cause[cause] = by_cause.get(cause, 0) + b
            by_direction[direction] += b
            crossings += n
        intermediate = sum(by_cause[c] for c in INTERMEDIATE_CAUSES)
        return {"crossings": crossings,
                "total_bytes": sum(by_cause.values()),
                "intermediate_bytes": intermediate,
                "by_cause": by_cause,
                "by_direction": by_direction,
                "by_stage": self.by_stage()}

    def clear(self) -> None:
        with self._lock:
            self._agg.clear()
            self._entries.clear()
