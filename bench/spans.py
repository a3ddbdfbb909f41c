"""Sums of the program's spans per execution, for the per-layer readers.

An execution is one ``q_key`` of the service's tracer with a ``query``
span in the window; a span counts for the execution whose ``q_key`` it
carries (the service stamps it on every span of a query's life, those of
admission on the client's thread included).
"""
from __future__ import annotations

from collections import defaultdict


def duration(span) -> float:
    return span.t1 - span.t0


def device_time(span):
    """The span's device seconds, or None where it was not device-timed
    (a program that times no span has no such field)."""
    return getattr(span, "device_s", None)


def per_execution(spans, names, value=duration, present=None):
    """``value`` summed over the spans named in ``names``, one sum per
    execution (0 for one with none of them); None when no span named in
    ``present`` (by default ``names``) has a value in the window."""
    present = set(names if present is None else present)
    sums, executions, found = defaultdict(float), set(), False
    for s in spans:
        key = s.attrs.get("q_key")
        if key is None or s.lane is not None:
            continue
        if s.name == "query":
            executions.add(key)
        if s.name not in names and s.name not in present:
            continue
        v = value(s)
        if v is None:
            continue
        found = found or s.name in present
        if s.name in names:
            sums[key] += v
    if not found or not executions:
        return None
    return [sums[k] for k in executions]


def mean_ms(values):
    return None if values is None else 1e3 * sum(values) / len(values)
