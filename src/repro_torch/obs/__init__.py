"""Observability: the query-lifecycle tracer (a copy of ``repro.obs.trace``,
which is framework-free)."""
from .trace import NULL_TRACER, NullTracer, SpanRecord, Tracer

__all__ = ["NULL_TRACER", "NullTracer", "SpanRecord", "Tracer"]
