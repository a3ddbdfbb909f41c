"""Concurrent join-query engine: admission, adaptive planning, caching.

The layer the ROADMAP's "production-scale system" needs over the join
stack: a service that accepts a stream of heterogeneous join requests,
plans each through the paper's cost model (scheme *and* SHJ-vs-PHJ choice
per query), executes on a shared two-group ``CoProcessor``, and reuses
resident build tables across queries.

  * ``JoinQueryService`` / ``JoinQuery``  — admission + execution
  * ``QueryPlanner`` / ``QueryPlan``      — per-query cost-model planning
  * ``BuildTableCache``                   — LRU build-table reuse
  * ``WorkloadGenerator`` / ``make_workload`` — scenario mixes
  * ``Tenant`` / ``TenantFairQueue`` / ``AdmissionController`` — the
    multi-tenant SLO layer: weighted fair share across tenants, EDF
    within, cost-priced shed/degrade with structured ``Backpressure``
  * ``open_loop`` — open-loop traffic simulation (Poisson/burst arrivals,
    tenant mixes, hot-tenant skew) for the ``slo_bench`` benchmark
  * ``QueryContext`` / ``BudgetEnforcer`` / ``RetryPolicy`` /
    ``BreakerBoard`` — the resilience layer: cooperative deadline
    preemption with checkpoint/resume, runtime C/G budget enforcement,
    and the retry → degrade → breaker → reference-path recovery ladder
  * ``FaultInjector`` / ``injected`` — deterministic seed-driven fault
    injection at the engine's kernel/h2d/d2h/worker/cache sites
  * ``Tracer`` / ``MetricsRegistry`` / ``CostAudit`` (re-exported from
    ``repro_torch.obs``) — query-lifecycle spans, the labeled-counter
    registry behind ``stats()``, and the predicted-vs-measured cost-model
    audit

Counterpart of ``repro.engine`` on the port's ``CoProcessor``: the C
group on the host CPU, the G group on the card.  ``JoinQueryService()``
and ``make_workload`` default to the card and raise without one; pass
``cp=CoProcessor(c_device="cpu", g_device="cpu")`` and ``device="cpu"``
to run on the CPU.  ``WorkloadGenerator.star``/``.analytic`` make
logical multi-join queries for ``repro_torch.queries.PipelineExecutor``.
"""
from ..obs import (CostAudit, DriftDetector, FlightRecorder,
                   MetricsRegistry, NULL_TRACER, NullTracer,
                   SLObjective, SLOMonitor, Tracer)

from .admission import (AdmissionController, AdmissionDecision,
                        Backpressure, Tenant, TenantFairQueue, jain_index)
from .faults import (FaultInjected, FaultInjector, FaultSpec, injected,
                     install as install_fault_injector, maybe_fault)
from .planner import (EXECUTABLE_SCHEMES, SCHEMES, QueryPlan, QueryPlanner)
from .resilience import (BreakerBoard, BudgetEnforcer, BudgetExceeded,
                         Cancelled, DeadlineExceeded, QueryContext,
                         RetryPolicy)
from .service import (GroupByQuery, JoinQuery, JoinQueryService,
                      PriorityAgingQueue, QueryOutcome, QueueFull)
from .table_cache import (BuildTableCache, partition_layout_key,
                          relation_fingerprint, table_nbytes)
from .workload import (MIXES, TrafficEvent, WorkloadGenerator,
                       make_workload, open_loop, zipf_keys)

__all__ = [n for n in dir() if not n.startswith("_")]
