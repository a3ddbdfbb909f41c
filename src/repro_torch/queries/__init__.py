"""Multi-join query pipeline over the concurrent join engine.

Counterpart of ``repro.queries``.  The paper frames hash joins as the core
of query co-processing; this package adds the query half: a declarative
multi-join IR (``plan``), a cost-model join-order optimizer that prices
each candidate stage through the engine's ``QueryPlanner`` — including a
transfer-cost term per stage hand-off (``optimize``) — and a pipelined
executor that streams the stages through ``JoinQueryService`` with
dependency-aware admission, device-resident stage hand-off
(``StageView`` rid-chains on the card; the host-materialize path remains
as a baseline), and build-side cache reuse (``executor``).

  * ``Table`` / ``Filter`` / ``Join`` / ``Query``      — logical plan IR
  * ``JoinOrderOptimizer`` / ``PhysicalPlan`` / ``PipelineStage``
  * ``PipelineExecutor`` / ``PipelineResult``
  * ``make_star_query`` / ``make_chain_query``          — query generators
  * ``reference_execute`` / ``rows_array``              — NumPy oracle

``PipelineExecutor()`` builds ``JoinQueryService(num_workers=2)`` on the
card and raises without one; on the CPU pass
``service=JoinQueryService(cp=CoProcessor(c_device="cpu",
g_device="cpu"))``.
"""
from .executor import PipelineExecutor, PipelineResult, StageView
from .optimize import JoinOrderOptimizer, PhysicalPlan, PipelineStage
from .plan import (JOIN_KINDS, NULL_VALUE, Filter, Join, Query, Table,
                   agg_output_name, apply_aggregate, apply_group_by,
                   make_chain_query, make_star_query, reference_execute,
                   reference_rows, rows_array)

__all__ = [n for n in dir() if not n.startswith("_")]
