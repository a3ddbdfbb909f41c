"""Cost-model join ordering: from a logical ``Query`` to a stage pipeline.

Any permutation of a query's join edges is executable as a *bushy* plan:
each edge joins the two components currently containing its endpoints (a
base table or an earlier stage's output).  The optimizer

  1. estimates every stage's intermediate cardinality with the classic
     System-R formulas — base tables from their selectivity annotations,
     joins as ``|A| * |B| / max(ndv(a), ndv(b))``;
  2. prices each stage through the engine's ``QueryPlanner.choose`` (the
     paper's §3.2/§4 machinery: co-processing scheme *and* SHJ-vs-PHJ per
     stage, from the calibrated ``SeriesCostModel``), build side = the
     smaller estimated input;
  3. searches orders — exhaustive over all edge permutations up to
     ``exhaustive_joins`` edges (Shanbhag et al.'s point that placement
     must be decided per operator makes per-stage pricing cheap enough to
     afford it), greedy cheapest-next-edge beyond that (>4 relations).

The emitted ``PhysicalPlan`` is a DAG of ``PipelineStage``s annotated with
the chosen scheme and algorithm; stages whose dependency sets are disjoint
(independent subtrees) run concurrently in the executor.  The estimate is
therefore an upper bound on wall time — pricing sums stages serially.

Stage hand-off pricing: every intermediate a later stage consumes pays a
transfer term.  Under ``handoff="host"`` (the materialize path) that is
``QueryPlanner.host_handoff_s`` over the result's rid pairs down and the
next stage's key relation back up — measured H2D/D2H unit cost; under
``handoff="device"`` (the fused path) intermediates never cross the host
and the term is ~0.  Because the term scales with the intermediate's
cardinality, a host-mode optimizer now sees what the serial left-to-right
sum alone could not: orders that keep the *large* intermediate off the
host boundary price ahead.

A copy of ``repro/queries/optimize.py`` over the port's ``QueryPlanner``:
the pricing is pure-Python float64, so plans equal the reference's to the
last bit.
"""
from __future__ import annotations

import dataclasses
import itertools

from ..engine.planner import QueryPlan, QueryPlanner

from .plan import Join, Query

# Result-capacity headroom over the estimated output cardinality; actual
# capacities are re-derived from realized input sizes at execution time.
EST_OUT_SLACK = 1.25

# Bytes one host-materialized hand-off moves per intermediate row: the
# (probe_rid, build_rid) result pair gathered down (8 B) plus the next
# stage's (rid, key) relation uploaded back (8 B).  Payload columns are
# gathered host-side from host-resident sources, so they cross no device
# boundary and are not priced here.
HOST_HANDOFF_BYTES_PER_ROW = 16


@dataclasses.dataclass
class PipelineStage:
    """One physical join stage of the pipeline (JoinQuery-compatible).

    ``build_input`` / ``probe_input`` name either a base table (str) or an
    earlier stage's output (int stage id); ``deps`` lists the stage ids
    this stage must wait for.
    """

    stage_id: int
    join: Join
    build_input: object           # str table name | int stage id
    probe_input: object
    build_col: str                # qualified "table.column"
    probe_col: str
    est_build: int
    est_probe: int
    est_out: int
    plan: QueryPlan               # scheme + SHJ-vs-PHJ annotation
    deps: tuple

    @property
    def kind(self) -> str:
        return self.join.kind

    def to_dict(self) -> dict:
        return {"stage_id": self.stage_id, "join": str(self.join),
                "kind": self.kind,
                "build_input": self.build_input,
                "probe_input": self.probe_input,
                "est_build": self.est_build, "est_probe": self.est_probe,
                "est_out": self.est_out, "algorithm": self.plan.algorithm,
                "scheme": self.plan.scheme, "est_s": self.plan.est_s,
                "deps": list(self.deps)}


@dataclasses.dataclass
class PhysicalPlan:
    stages: list
    order: tuple                  # the join-edge order that produced it
    est_total_s: float
    aggregate: tuple | None = None
    # Cycle edges: a join whose endpoints already share a component is a
    # residual equality filter, applied to that component's output —
    # (ref, left_q, right_q) where ref is a table name or stage id.
    residuals: tuple = ()
    # Group-by sink (when the query has one): the planner's scheme choice
    # for the aggregation stage, priced into est_total_s.
    group_by: tuple = ()
    agg_plan: QueryPlan | None = None

    def describe(self) -> str:
        lines = [f"physical plan — est {self.est_total_s * 1e3:.2f} ms"]
        for s in self.stages:
            src = (lambda x: x if isinstance(x, str) else f"#{x}")
            lines.append(
                f"  #{s.stage_id}: {src(s.build_input)} ⋈ "
                f"{src(s.probe_input)} on {s.join}  "
                f"[{s.plan.algorithm}/{s.plan.scheme}] "
                f"est {s.est_build}x{s.est_probe} -> {s.est_out}, "
                f"{s.plan.est_s * 1e3:.2f} ms"
                + (f" (after {list(s.deps)})" if s.deps else ""))
        if self.agg_plan is not None:
            lines.append(
                f"  sink: group by {list(self.group_by)} "
                f"[groupby/{self.agg_plan.scheme}] "
                f"{self.agg_plan.est_s * 1e3:.2f} ms")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {"est_total_s": self.est_total_s,
                "order": [str(j) for j in self.order],
                "residuals": [[str(x) for x in r] for r in self.residuals],
                "group_by": list(self.group_by),
                "agg_scheme": (self.agg_plan.scheme
                               if self.agg_plan else None),
                "stages": [s.to_dict() for s in self.stages]}


class _Component:
    """Optimizer-side summary of a base table or intermediate result."""

    def __init__(self, ref, rows: float, ndv: dict):
        self.ref = ref            # str table name | int stage id
        self.rows = max(1.0, rows)
        self.ndv = ndv            # qualified col -> estimated distinct
        self.deps = () if isinstance(ref, str) else None  # set by caller

    def col_ndv(self, q: str) -> float:
        return max(1.0, min(self.ndv.get(q, self.rows), self.rows))


def _base_component(query: Query, name: str) -> _Component:
    t = query.tables[name]
    rows = t.est_rows()
    ndv = {f"{name}.{c}": t.ndv_est(c) for c in t.columns}
    return _Component(name, rows, ndv)


class JoinOrderOptimizer:
    """Enumerates and prices join orders; emits the cheapest pipeline."""

    def __init__(self, planner: QueryPlanner | None = None, *,
                 exhaustive_joins: int = 4, handoff: str = "device"):
        self.planner = planner or QueryPlanner()
        # > exhaustive_joins edges (i.e. > ~4-5 relations): greedy search.
        self.exhaustive_joins = int(exhaustive_joins)
        # How stage intermediates reach their consumers: "device" (fused
        # hand-off, ~free) or "host" (materialized, priced per row via
        # the planner's measured H2D/D2H unit cost).  Match the executor's
        # ``handoff`` mode so estimates track what will actually run.
        if handoff not in ("device", "host"):
            raise ValueError(f"unknown handoff mode {handoff!r}")
        self.handoff = handoff

    # -- pricing one order ---------------------------------------------------
    def price_order(self, query: Query, order, *,
                    observed_rows: dict | None = None,
                    record: bool = True) -> PhysicalPlan:
        """Simulate ``order`` edge by edge, pricing every stage.

        ``observed_rows`` maps ``id(join_edge) -> exact output rows`` for
        already-executed stages (the adaptive replan path): an overridden
        edge's output — and therefore everything the System-R recurrence
        derives downstream of it (input sizes, ndv caps, hand-off terms)
        — is priced from what the device actually measured instead of the
        estimate.  ``record=False`` keeps mid-pipeline re-pricing out of
        the planner's plan-count bookkeeping, exactly like admission-time
        pricing.
        """
        observed = observed_rows or {}
        comps = {name: _base_component(query, name) for name in query.tables}
        stages: list[PipelineStage] = []
        residuals: list = []
        total = 0.0
        final = next(iter(comps.values()))
        for join in order:
            left, right = comps[join.left], comps[join.right]
            if join.kind in ("semi", "anti"):
                # Filter edge: the right table builds, the left component
                # probes for match flags.  Output rows shrink to the
                # left's matching (or non-matching) fraction — this is
                # the cardinality reduction that makes the optimizer
                # schedule semi filters early.
                sel = 1.0 / max(left.col_ndv(join.left_q),
                                right.col_ndv(join.right_q))
                p_match = min(1.0, right.rows * sel)
                frac = p_match if join.kind == "semi" else 1.0 - p_match
                out_rows = max(1.0, left.rows * frac)
                if id(join) in observed:
                    out_rows = max(1.0, float(observed[id(join)]))
                plan = self.planner.choose(
                    int(round(right.rows)), int(round(left.rows)),
                    max_out=max(64, int(out_rows * EST_OUT_SLACK) + 64),
                    kind=join.kind, record=record)
                deps = tuple(sorted(
                    {r for r in (left.ref,) if isinstance(r, int)}))
                stage = PipelineStage(
                    stage_id=len(stages), join=join,
                    build_input=right.ref, probe_input=left.ref,
                    build_col=join.right_q, probe_col=join.left_q,
                    est_build=int(round(right.rows)),
                    est_probe=int(round(left.rows)),
                    est_out=int(round(out_rows)), plan=plan, deps=deps)
                stages.append(stage)
                total += plan.est_s
                merged = _Component(stage.stage_id, out_rows,
                                    {q: min(n, out_rows)
                                     for q, n in left.ndv.items()})
                for name, c in comps.items():
                    if c is left or c is right:
                        comps[name] = merged
                final = merged
                continue
            if join.kind == "left_outer" and left is not right:
                # Preserved side probes; every left row survives.
                sel = 1.0 / max(right.col_ndv(join.right_q),
                                left.col_ndv(join.left_q))
                inner_out = left.rows * right.rows * sel
                out_rows = max(left.rows, inner_out)
                if id(join) in observed:
                    out_rows = max(1.0, float(observed[id(join)]))
                plan = self.planner.choose(
                    int(round(right.rows)), int(round(left.rows)),
                    max_out=max(64, int(out_rows * EST_OUT_SLACK) + 64),
                    kind=join.kind, record=record)
                deps = tuple(sorted(
                    {r for r in (right.ref, left.ref)
                     if isinstance(r, int)}))
                stage = PipelineStage(
                    stage_id=len(stages), join=join,
                    build_input=right.ref, probe_input=left.ref,
                    build_col=join.right_q, probe_col=join.left_q,
                    est_build=int(round(right.rows)),
                    est_probe=int(round(left.rows)),
                    est_out=int(round(out_rows)), plan=plan, deps=deps)
                stages.append(stage)
                total += plan.est_s
                merged = _Component(stage.stage_id, out_rows,
                                    {q: min(n, out_rows)
                                     for q, n in {**right.ndv,
                                                  **left.ndv}.items()})
                for name, c in comps.items():
                    if c is left or c is right:
                        comps[name] = merged
                final = merged
                continue
            if left is right:
                # Cycle edge: both sides already joined — an equality
                # filter on the component, not a stage.
                sel = 1.0 / max(left.col_ndv(join.left_q),
                                left.col_ndv(join.right_q))
                rows = max(1.0, left.rows * sel)
                shrunk = _Component(left.ref, rows,
                                    {q: min(n, rows)
                                     for q, n in left.ndv.items()})
                residuals.append((left.ref, join.left_q, join.right_q))
                for name, c in comps.items():
                    if c is left:
                        comps[name] = shrunk
                final = shrunk
                continue
            # Build side = smaller estimated input (ties go right: dims
            # typically appear on the right of a star query's edges).
            if left.rows < right.rows:
                build, probe = left, right
                build_col, probe_col = join.left_q, join.right_q
            else:
                build, probe = right, left
                build_col, probe_col = join.right_q, join.left_q
            sel = 1.0 / max(build.col_ndv(build_col),
                            probe.col_ndv(probe_col))
            out_rows = max(1.0, build.rows * probe.rows * sel)
            if id(join) in observed:
                out_rows = max(1.0, float(observed[id(join)]))
            plan = self.planner.choose(
                int(round(build.rows)), int(round(probe.rows)),
                max_out=max(64, int(out_rows * EST_OUT_SLACK) + 64),
                record=record)
            deps = tuple(sorted(
                {r for r in (build.ref, probe.ref) if isinstance(r, int)}))
            stage = PipelineStage(
                stage_id=len(stages), join=join,
                build_input=build.ref, probe_input=probe.ref,
                build_col=build_col, probe_col=probe_col,
                est_build=int(round(build.rows)),
                est_probe=int(round(probe.rows)),
                est_out=int(round(out_rows)), plan=plan, deps=deps)
            stages.append(stage)
            total += plan.est_s
            merged = _Component(stage.stage_id, out_rows,
                                {q: min(n, out_rows)
                                 for q, n in {**build.ndv,
                                              **probe.ndv}.items()})
            for name, c in comps.items():
                if c is left or c is right:
                    comps[name] = merged
            final = merged
        # Hand-off term: every intermediate consumed by a later stage pays
        # its transfer cost — the measured host round trip when stages
        # materialize, ~0 when hand-off is device-resident.
        if self.handoff == "host":
            consumed = {d for s in stages for d in s.deps}
            for s in stages:
                if s.stage_id in consumed:
                    total += self.planner.host_handoff_s(
                        HOST_HANDOFF_BYTES_PER_ROW * s.est_out)
        agg_plan = None
        if query.group_by:
            # The aggregation sink, priced like any other operator: the
            # planner's scheme choice over the pipeline's estimated final
            # cardinality (group-by cost does not depend on join order
            # beyond that cardinality, so it cannot flip the ordering —
            # but it belongs in est_total_s for plan-vs-measured honesty).
            agg_plan = self.planner.choose_groupby(
                max(1, int(round(final.rows))), record=record)
            total += agg_plan.est_s
        return PhysicalPlan(stages=stages, order=tuple(order),
                            est_total_s=total, aggregate=query.aggregate,
                            residuals=tuple(residuals),
                            group_by=query.group_by, agg_plan=agg_plan)

    # -- search --------------------------------------------------------------
    def enumerate_orders(self, query: Query):
        """Every executable edge order (any permutation is a bushy plan).

        Inner joins commute, and semi/anti edges are per-row filters on
        their left component (duplication-insensitive), so they permute
        freely.  Left-outer joins do NOT commute with joins/filters that
        shrink the preserved side — a query containing one executes in
        textual order only, which is the order the reference defines.
        """
        if any(j.kind == "left_outer" for j in query.joins):
            return [tuple(query.joins)]
        return [tuple(p) for p in itertools.permutations(query.joins)]

    def _greedy_order(self, query: Query):
        """Cheapest-marginal-stage-first (for beyond-exhaustive edge counts).

        At each step, price every remaining edge as the *next* stage of the
        partial plan and commit the cheapest — O(edges²) planner calls.
        """
        remaining = list(query.joins)
        chosen: list[Join] = []
        while remaining:
            best, best_cost = None, None
            for j in remaining:
                candidate = chosen + [j]
                plan = self.price_order(query, candidate)
                cost = (plan.est_total_s, plan.stages[-1].est_out
                        if plan.stages else 0)
                if best_cost is None or cost < best_cost:
                    best, best_cost = j, cost
            chosen.append(best)
            remaining.remove(best)
        return tuple(chosen)

    def optimize(self, query: Query) -> PhysicalPlan:
        """The cheapest priced order (exhaustive when small, else greedy)."""
        if any(j.kind == "left_outer" for j in query.joins):
            candidates = [tuple(query.joins)]       # not reorderable
        elif len(query.joins) <= self.exhaustive_joins:
            candidates = self.enumerate_orders(query)
        else:
            candidates = [self._greedy_order(query)]
        priced = [self.price_order(query, order) for order in candidates]
        # Never worse than the textual left-deep order: it is always one of
        # the exhaustive candidates, and the greedy path falls back to it
        # if its pick prices above the baseline.
        baseline = self.price_order(query, query.joins)
        best = min(priced, key=lambda p: p.est_total_s)
        return best if best.est_total_s <= baseline.est_total_s else baseline

    def worst_order(self, query: Query) -> PhysicalPlan:
        """The most expensive enumerated order (benchmark foil)."""
        priced = [self.price_order(query, order)
                  for order in self.enumerate_orders(query)]
        return max(priced, key=lambda p: p.est_total_s)

    # -- adaptive mid-pipeline re-optimization -------------------------------
    def reprice_remaining(self, query: Query, executed_order,
                          remaining_order,
                          observed_rows: dict) -> PhysicalPlan | None:
        """Re-order not-yet-admitted stages from observed cardinalities.

        ``executed_order`` is the join-edge prefix the executor already
        ran (its exact output rows in ``observed_rows``, keyed by
        ``id(edge)``); ``remaining_order`` is the incumbent plan's tail.
        Every candidate keeps the executed prefix verbatim and permutes
        only the tail, so nothing already running is invalidated.  Returns
        the re-priced full plan when a different tail beats the incumbent
        tail by the planner's ``replan_margin`` (the same hysteresis that
        guards sticky per-stage replans — flipping stage order mid-flight
        trades warmed caches and compiled executables for the estimated
        gain, so near-ties stay put), else ``None``.

        Outer queries pin textual order (``enumerate_orders``); they are
        never re-ordered.  Tails beyond ``exhaustive_joins`` edges are
        left alone too — by then the executed prefix has shrunk the
        problem or it was greedy-planned to begin with.
        """
        executed = tuple(executed_order)
        remaining = tuple(remaining_order)
        if (len(remaining) < 2 or len(remaining) > self.exhaustive_joins
                or any(j.kind == "left_outer" for j in query.joins)):
            return None
        incumbent = self.price_order(query, executed + remaining,
                                     observed_rows=observed_rows,
                                     record=False)
        # One stage per executed edge (cycle edges produce residual
        # filters, not stages — the executor does not replan those).
        if len(incumbent.stages) != len(executed) + len(remaining):
            return None
        prefix_s = sum(s.plan.est_s
                       for s in incumbent.stages[:len(executed)])
        best, best_tail = incumbent, remaining
        for tail in itertools.permutations(remaining):
            if tail == remaining:
                continue
            cand = self.price_order(query, executed + tail,
                                    observed_rows=observed_rows,
                                    record=False)
            if cand.est_total_s < best.est_total_s:
                best, best_tail = cand, tail
        if best_tail == remaining:
            return None
        # Hysteresis over the *tail* cost: the executed prefix is sunk and
        # identical in both plans, so it must not dilute the margin.
        if not self.planner.replan_beats(best.est_total_s - prefix_s,
                                         incumbent.est_total_s - prefix_s):
            return None
        return best
