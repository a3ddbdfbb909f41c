"""Observability: query-lifecycle tracing, metrics, cost-model audit,
cardinality audit, host-transfer ledger, flight recording, SLO burn-rate
monitoring and drift detection (copies of ``repro.obs``, which is
framework-free), plus the port's CUDA-event timers (``timing``)."""
from .audit import CostAudit
from .cardinality import CardinalityAudit, q_error
from .drift import DriftDetector, PageHinkley
from .flight import (FlightRecorder, dump_live_recorders, summarize_outcome,
                     validate_dump)
from .ledger import CAUSES, INTERMEDIATE_CAUSES, TransferLedger
from .metrics import MetricsRegistry
from .slo import SLObjective, SLOMonitor, default_objectives
from .trace import NULL_TRACER, NullTracer, SpanRecord, Tracer

__all__ = ["CAUSES", "CardinalityAudit", "CostAudit", "DriftDetector",
           "FlightRecorder", "INTERMEDIATE_CAUSES", "MetricsRegistry",
           "NULL_TRACER", "NullTracer", "PageHinkley", "SLObjective",
           "SLOMonitor", "SpanRecord", "Tracer", "TransferLedger",
           "default_objectives", "dump_live_recorders", "q_error",
           "summarize_outcome", "validate_dump"]
