"""Query-lifecycle tracing: lightweight spans with an injectable clock.

The counterpart of ``repro/obs/trace.py``, with two additions for the
card: device-timed spans, and a ring that keeps the newest spans.

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

A span opened with ``device=`` a CUDA device is also *device-timed*: a
CUDA timing event is recorded on that device's current stream as it
opens and as it closes, and its record's ``device_s`` is the device time
between the two (other threads' work queued on that stream between them
included).  The events come from a pool the tracer keeps, and are read
(and returned to the pool) by :meth:`Tracer.resolve_device`, which
reading the spans calls: the join service reads a query's spans once it
has released its device-group locks.  Until then ``device_s`` is
``None``, as it stays for untimed spans and CPU devices.

Counts a span gathers on the card (:meth:`_ActiveSpan.count`, e.g. the
CSR expand's pairs) are copied to pinned host memory on the span's
stream before its closing event, and enter its ``attrs`` when
:meth:`Tracer.resolve_device` finds that event passed: no wait on the
host.  Counts in CPU tensors enter ``attrs`` at once.

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

import collections
import dataclasses
import itertools
import json
import threading
import time

import torch

# Attribute keys a child span inherits from its innermost open ancestor
# on the same thread (unless it sets them itself).
AMBIENT_ATTRS = ("q_key", "query_id", "tenant", "tag", "scheme")
# Device-timed spans left pending before opening another resolves them.
MAX_PENDING = 64


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
    # Device seconds of a device-timed span, once resolved; else None.
    device_s: float | None = None

    def to_dict(self) -> dict:
        return {"name": self.name, "t0": self.t0, "t1": self.t1,
                "dur_s": self.t1 - self.t0, "thread": self.thread,
                "lane": self.lane, "attrs": dict(self.attrs),
                "device_s": self.device_s}


class _ActiveSpan:
    """A span while it is open: the context manager ``Tracer.span``
    returns, and the mutable handle it yields."""

    __slots__ = ("tracer", "name", "t0", "attrs", "device", "stream",
                 "start", "counts")

    def __init__(self, tracer: "Tracer", name: str, device, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.device = device
        self.attrs = attrs
        self.start = None
        self.counts = []

    def set(self, **attrs) -> None:
        """Attach attributes discovered mid-span (e.g. the chosen plan's
        scheme, known only after planning but ambient for the phases)."""
        self.attrs.update((k, v) for k, v in attrs.items() if v is not None)

    def count(self, names, values: torch.Tensor) -> None:
        """Attach integer counts ``values`` (a 1-D tensor) under
        ``names``.  A CUDA tensor is read once the span's closing event
        has passed (the span must be device-timed on its device); a CPU
        tensor at once."""
        if values.device.type != "cuda":
            self.attrs.update(zip(names, values.tolist()))
            return
        if self.start is None:
            raise ValueError(f"counts on {values.device} in a span not "
                             f"device-timed")
        host = torch.empty(values.shape, dtype=values.dtype,
                           pin_memory=True)
        host.copy_(values, non_blocking=True)
        self.counts.append((tuple(names), host))

    def __enter__(self) -> "_ActiveSpan":
        tracer = self.tracer
        stack = tracer._stack()
        attrs = self.attrs
        if stack:
            parent = stack[-1].attrs
            for k in AMBIENT_ATTRS:
                if k in parent and k not in attrs:
                    attrs[k] = parent[k]
        self.attrs = {k: v for k, v in attrs.items() if v is not None}
        self.t0 = tracer.now()
        stack.append(self)
        if self.device is not None:
            self.stream = torch.cuda.current_stream(self.device)
            self.start = tracer._event(self.device)
            self.start.record(self.stream)
        return self

    def __exit__(self, *exc) -> bool:
        tracer = self.tracer
        timed = None
        if self.start is not None:
            end = tracer._event(self.device)
            end.record(self.stream)
            timed = (self.device, self.start, end)
        tracer._stack().pop()
        tracer._finish(SpanRecord(self.name, self.t0, tracer.now(),
                                  threading.current_thread().name,
                                  self.attrs), timed, self.counts)
        return False


class _NoSpan:
    """What a disabled tracer's ``span`` returns: yields ``None``."""

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


class Tracer:
    """Thread-safe span recorder with an injectable clock.

    ``clock`` must be monotonic within one tracer (tests inject fake
    clocks).  Finished spans are kept in a ring of the newest
    ``max_spans``: the oldest go first, with their per-``q_key`` index
    entries, and :attr:`dropped` counts them.  Per-``q_key`` indexing
    serves the structured per-query trace on ``QueryOutcome``.
    """

    def __init__(self, clock=time.perf_counter, *, enabled: bool = True,
                 max_spans: int = 200_000):
        self.enabled = bool(enabled)
        self.max_spans = int(max_spans)
        self._clock = clock
        self._lock = threading.Lock()
        self._spans: collections.deque[SpanRecord] = collections.deque()
        self._dropped = 0
        self._by_key: dict[int, list[SpanRecord]] = {}
        self._local = threading.local()
        self._key_seq = itertools.count(1)
        # Free CUDA timing events, per device, and the device-timed spans
        # not yet resolved: (record, device, start event, end event), with
        # their counts by id(record): [(names, pinned host counts)].
        self._events: dict = {}
        self._pending: list = []
        self._pending_counts: dict = {}

    @property
    def dropped(self) -> int:
        """Spans dropped from the ring, oldest first, since the last
        ``clear``."""
        return self._dropped

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
    def span(self, name: str, *, device=None, **attrs):
        """Open a nested span on the calling thread (a context manager).

        Yields the active span (``.set(**attrs)`` adds attributes
        mid-flight) or ``None`` when the tracer is disabled.  ``None``
        attribute values are dropped; ambient keys are inherited from the
        innermost open ancestor on this thread.  ``device``, a CUDA
        ``torch.device``, times the span on that device too (its
        record's ``device_s``, set by :meth:`resolve_device`).
        """
        if not self.enabled:
            return _NO_SPAN
        if device is not None and device.type != "cuda":
            device = None
        return _ActiveSpan(self, name, device, attrs)

    def _event(self, device):
        """A CUDA timing event for ``device``, from the pool if it has
        one.  Where nothing reads the spans, many pending ones are
        resolved here, so their events come back to the pool."""
        if len(self._pending) > MAX_PENDING:
            self.resolve_device()
        with self._lock:
            pool = self._events.get(device)
            if pool:
                return pool.pop()
        return torch.cuda.Event(enable_timing=True)

    def resolve_device(self) -> None:
        """Set ``device_s`` on the device-timed spans whose closing event
        the device has passed, with their counts, and return their events
        to the pool.  It never waits: a span the device has not passed
        stays pending for the next call.  :meth:`spans` and
        :meth:`spans_for` call it."""
        if not self._pending:
            return
        with self._lock:
            pending, self._pending = self._pending, []
        done, left = [], []
        for item in pending:
            (done if item[3].query() else left).append(item)
        with self._lock:
            counts = [self._pending_counts.pop(id(item[0]), ())
                      for item in done]
        for (rec, _, start, end), held in zip(done, counts):
            rec.device_s = start.elapsed_time(end) / 1e3
            for names, host in held:
                rec.attrs.update(zip(names, host.tolist()))
        with self._lock:
            self._pending[:0] = left
            for _, device, start, end in done:
                self._events.setdefault(device, []).extend((start, end))

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

    def _finish(self, rec: SpanRecord, timed=None, counts=()) -> None:
        with self._lock:
            if timed is not None:
                self._pending.append((rec, *timed))
                if counts:
                    self._pending_counts[id(rec)] = counts
            if self.max_spans <= 0:
                self._dropped += 1
                return
            if len(self._spans) >= self.max_spans:
                self._unindex(self._spans.popleft())
                self._dropped += 1
            self._spans.append(rec)
            key = rec.attrs.get("q_key")
            if key is not None:
                # The per-query index is bounded by wholesale reset: one
                # query contributes ~10 spans, so the cap is generous.
                if len(self._by_key) > 8192:
                    self._by_key.clear()
                self._by_key.setdefault(key, []).append(rec)

    def _unindex(self, old: SpanRecord) -> None:
        """Drop a span leaving the ring from the per-query index.  A
        key's list is in completion order, so the oldest span is first
        (unless the index was reset since, and it is not there)."""
        key = old.attrs.get("q_key")
        recs = self._by_key.get(key) if key is not None else None
        if recs and recs[0] is old:
            del recs[0]
            if not recs:
                del self._by_key[key]

    # -- reading -------------------------------------------------------------
    def spans(self) -> list[SpanRecord]:
        self.resolve_device()
        with self._lock:
            return list(self._spans)

    def spans_for(self, key) -> list[dict]:
        """Structured per-query trace: every finished span stamped with
        this ``q_key``, in completion order (what ``QueryOutcome.trace``
        carries)."""
        self.resolve_device()
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
                args = dict(r.attrs)
                if r.device_s is not None:
                    args["device_s"] = r.device_s
                events.append({"ph": "X", "cat": "span", "name": r.name,
                               "pid": 1, "tid": tid_of(r.thread),
                               "ts": ts, "dur": dur, "args": args})
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
