"""Query-lifecycle tracing: lightweight spans with an injectable clock.

A copy of ``repro/obs/trace.py`` (no framework imports).

The engine's observability substrate.  A ``Tracer`` records *spans* —
named, attributed time intervals — from every layer of a query's life:

    admit -> queue -> plan -> partition -> build -> probe -> gather/agg
          -> finalize

Spans opened with :meth:`Tracer.span` nest per thread via a thread-local
stack, so worker threads and deferred pipeline stages each get a
correctly nested lane; *ambient* attributes (``q_key``, ``query_id``,
``tenant``, ``tag``, ``scheme``) flow from a parent span to its children
automatically, which is how a ``CoProcessor`` phase span deep inside a
kernel wrapper ends up tagged with the query that caused it without the
kernel knowing anything about queries.

Retroactive intervals that *cannot* nest on a thread's stack — queue
wait is measured on the submitting thread but ends on a worker — are
recorded with :meth:`Tracer.lane` and exported as Chrome *async* events,
which carry no nesting constraint.

Exports:

  * :meth:`Tracer.chrome_trace` / :meth:`Tracer.write_chrome_trace` —
    Chrome trace-event JSON (open in https://ui.perfetto.dev).
  * :meth:`Tracer.spans_for` — the structured per-query span list that
    ``JoinQueryService`` attaches to ``QueryOutcome.trace``.

``NullTracer`` (singleton ``NULL_TRACER``) is the no-op recorder: every
call is a cheap early return, so a standalone ``CoProcessor`` — which
defaults to it — pays nothing for the plumbing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import threading
import time

# Attribute keys a child span inherits from its innermost open ancestor
# on the same thread (unless it sets them itself).
AMBIENT_ATTRS = ("q_key", "query_id", "tenant", "tag", "scheme")


@dataclasses.dataclass
class SpanRecord:
    """One finished span: a closed interval on the tracer's clock."""

    name: str
    t0: float
    t1: float
    thread: str
    attrs: dict
    # Non-None marks an async "lane" interval (e.g. queue wait) that is
    # exempt from per-thread nesting and exported as Chrome b/e events.
    lane: str | None = None

    def to_dict(self) -> dict:
        return {"name": self.name, "t0": self.t0, "t1": self.t1,
                "dur_s": self.t1 - self.t0, "thread": self.thread,
                "lane": self.lane, "attrs": dict(self.attrs)}


class _ActiveSpan:
    """Mutable handle yielded by ``Tracer.span`` while the span is open."""

    __slots__ = ("name", "t0", "attrs")

    def __init__(self, name: str, t0: float, attrs: dict):
        self.name = name
        self.t0 = t0
        self.attrs = attrs

    def set(self, **attrs) -> None:
        """Attach attributes discovered mid-span (e.g. the chosen plan's
        scheme, known only after planning but ambient for the phases)."""
        self.attrs.update((k, v) for k, v in attrs.items() if v is not None)


class Tracer:
    """Thread-safe span recorder with an injectable clock.

    ``clock`` must be monotonic within one tracer (tests inject fake
    clocks).  Finished spans are kept in a bounded ring; per-``q_key``
    indexing serves the structured per-query trace on ``QueryOutcome``.
    """

    def __init__(self, clock=time.perf_counter, *, enabled: bool = True,
                 max_spans: int = 200_000):
        self.enabled = bool(enabled)
        self.max_spans = int(max_spans)
        self._clock = clock
        self._lock = threading.Lock()
        self._spans: list[SpanRecord] = []
        self._dropped = 0
        self._by_key: dict[int, list[SpanRecord]] = {}
        self._local = threading.local()
        self._key_seq = itertools.count(1)

    # -- clocks and keys -----------------------------------------------------
    def now(self) -> float:
        return self._clock()

    def next_key(self) -> int:
        """Allocate a per-execution correlation key (``q_key``).  Unique
        per tracer; stamped on every span of one query's lifecycle."""
        return next(self._key_seq)

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    # -- recording -----------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Open a nested span on the calling thread.

        Yields the active span (``.set(**attrs)`` adds attributes
        mid-flight) or ``None`` when the tracer is disabled.  ``None``
        attribute values are dropped; ambient keys are inherited from the
        innermost open ancestor on this thread.
        """
        if not self.enabled:
            yield None
            return
        stack = self._stack()
        if stack:
            parent = stack[-1].attrs
            for k in AMBIENT_ATTRS:
                if k in parent and k not in attrs:
                    attrs[k] = parent[k]
        attrs = {k: v for k, v in attrs.items() if v is not None}
        sp = _ActiveSpan(name, self.now(), attrs)
        stack.append(sp)
        try:
            yield sp
        finally:
            stack.pop()
            self._finish(SpanRecord(name, sp.t0, self.now(),
                                    threading.current_thread().name,
                                    sp.attrs))

    def lane(self, name: str, t0: float, t1: float, *,
             lane: str = "queue", **attrs) -> None:
        """Record a retroactive interval on a named async lane.

        Lane intervals start on one thread and end on another (queue
        wait), so they are exempt from per-thread nesting and become
        Chrome async (``b``/``e``) events rather than ``X`` slices.
        """
        if not self.enabled:
            return
        attrs = {k: v for k, v in attrs.items() if v is not None}
        self._finish(SpanRecord(name, float(t0), max(float(t0), float(t1)),
                                threading.current_thread().name,
                                attrs, lane=lane))

    def instant(self, name: str, **attrs) -> None:
        """Record a zero-length event (e.g. an admission shed decision)."""
        if not self.enabled:
            return
        stack = self._stack()
        if stack:
            parent = stack[-1].attrs
            for k in AMBIENT_ATTRS:
                if k in parent and k not in attrs:
                    attrs[k] = parent[k]
        attrs = {k: v for k, v in attrs.items() if v is not None}
        t = self.now()
        self._finish(SpanRecord(name, t, t,
                                threading.current_thread().name, attrs))

    def _finish(self, rec: SpanRecord) -> None:
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self._dropped += 1
                return
            self._spans.append(rec)
            key = rec.attrs.get("q_key")
            if key is not None:
                # The per-query index is bounded by wholesale reset: one
                # query contributes ~10 spans, so the cap is generous.
                if len(self._by_key) > 8192:
                    self._by_key.clear()
                self._by_key.setdefault(key, []).append(rec)

    # -- reading -------------------------------------------------------------
    def spans(self) -> list[SpanRecord]:
        with self._lock:
            return list(self._spans)

    def spans_for(self, key) -> list[dict]:
        """Structured per-query trace: every finished span stamped with
        this ``q_key``, in completion order (what ``QueryOutcome.trace``
        carries)."""
        with self._lock:
            return [r.to_dict() for r in self._by_key.get(key, ())]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._by_key.clear()
            self._dropped = 0

    # -- Chrome trace-event export -------------------------------------------
    def chrome_trace(self) -> list[dict]:
        """Render finished spans as Chrome trace events.

        Thread spans become complete (``"X"``) events — nesting per
        ``tid`` is guaranteed because they were built from per-thread
        stacks.  Lane intervals become async begin/end (``"b"``/``"e"``)
        pairs on a synthetic lane track.  Timestamps are microseconds
        relative to the earliest recorded span (never negative), sorted
        ascending; ``"M"`` metadata events name the tracks.
        """
        recs = self.spans()
        if not recs:
            return []
        epoch = min(r.t0 for r in recs)
        tids: dict[str, int] = {}

        def tid_of(track: str) -> int:
            if track not in tids:
                tids[track] = len(tids) + 1
            return tids[track]

        events: list[dict] = []
        async_id = 0
        for r in recs:
            ts = max(0.0, r.t0 - epoch) * 1e6
            dur = max(0.0, r.t1 - r.t0) * 1e6
            if r.lane is not None:
                async_id += 1
                tid = tid_of(f"lane:{r.lane}")
                events.append({"ph": "b", "cat": r.lane, "id": async_id,
                               "name": r.name, "pid": 1, "tid": tid,
                               "ts": ts, "args": dict(r.attrs)})
                events.append({"ph": "e", "cat": r.lane, "id": async_id,
                               "name": r.name, "pid": 1, "tid": tid,
                               "ts": ts + dur})
            else:
                events.append({"ph": "X", "cat": "span", "name": r.name,
                               "pid": 1, "tid": tid_of(r.thread),
                               "ts": ts, "dur": dur,
                               "args": dict(r.attrs)})
        # Stable order: ascending ts; at equal ts the longer slice first
        # so a parent precedes its children (fake clocks produce ties).
        events.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        meta = [{"ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
                 "args": {"name": track}}
                for track, tid in sorted(tids.items(), key=lambda kv: kv[1])]
        return meta + events

    def write_chrome_trace(self, path) -> str:
        """Write the Chrome trace JSON (Perfetto/chrome://tracing load it
        directly).  Returns the path written."""
        payload = {"traceEvents": self.chrome_trace(),
                   "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(payload, f)
        return str(path)


class NullTracer(Tracer):
    """No-op recorder: the default for a standalone ``CoProcessor``.

    Every entry point is an ``enabled`` check followed by an early
    return, so instrumented code paths cost a branch when tracing is off.
    """

    def __init__(self):
        super().__init__(enabled=True, max_spans=0)
        self.enabled = False


#: Shared no-op tracer instance (safe to share: it never records).
NULL_TRACER = NullTracer()
