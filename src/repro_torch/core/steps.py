"""Fine-grained step framework (paper §3.1).

A copy of ``repro/core/steps.py`` (pure Python).

A *step* is a data-parallel map over input items (tuples or larger units)
with optional shared read-only state and optional reduction-style partial
outputs.  A *step series* is a list of steps separated by data dependencies;
series are separated by barriers (build | probe, or per-pass partitioning).

Co-processing schemes (OL / DD / PL, §3.2) assign each step a workload ratio
``r_i``: the first ``round(r_i * x_i)`` items run on the C-group and the rest
on the G-group.  The framework carries per-step cost metadata (paper Table 2)
so the cost model can price any ratio assignment.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

Env = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class StepCost:
    """Per-item cost coefficients for one step (paper §4, Table 2).

    ``ops_per_item``        — ALU ops per item (the paper's #I, profiled).
    ``seq_bytes_per_item``  — streaming bytes per item.
    ``rand_accesses_per_item`` — random-gather/scatter count per item (the
                              dominant cause of memory stalls for hash joins).
    ``out_bytes_per_item``  — bytes of intermediate result per item that flow
                              to the next step (prices the PL link term).
    """

    ops_per_item: float
    seq_bytes_per_item: float
    rand_accesses_per_item: float
    out_bytes_per_item: float = 8.0
    workload_dependent: bool = False  # e.g. b3/p3 scale with key-list length


@dataclasses.dataclass(frozen=True)
class Step:
    """One fine-grained step.

    ``apply(shared, items) -> (items_out, shared_out)``:
      * ``items``  — dict of equal-length per-item arrays (ratio-splittable).
      * ``shared`` — dict of broadcast state (hash table, headers, ...).
      * ``items_out``  — per-item outputs (same leading dim as ``items``).
      * ``shared_out`` — partial reductions; merged across groups per
        ``combine[key]`` ("add" for histograms, "concat", or "replace").
    """

    name: str
    apply: Callable[[Env, Env], tuple[Env, Env]]
    cost: StepCost
    combine: dict[str, str] = dataclasses.field(default_factory=dict)
    splittable: bool = True


@dataclasses.dataclass(frozen=True)
class StepSeries:
    """Steps between two barriers; a tuple flows through all of them."""

    name: str
    steps: tuple[Step, ...]

    @property
    def names(self) -> list[str]:
        return [s.name for s in self.steps]


def run_series(series: StepSeries, shared: Env, items: Env) -> tuple[Env, Env]:
    """Single-processor reference execution (no co-processing)."""
    for step in series.steps:
        items_out, shared_out = step.apply(shared, items)
        items = items_out
        shared = {**shared, **shared_out}
    return items, shared


def split_items(items: Env, cut: int) -> tuple[Env, Env]:
    """Split every per-item array at ``cut`` (C-group gets [:cut])."""
    head = {k: v[:cut] for k, v in items.items()}
    tail = {k: v[cut:] for k, v in items.items()}
    return head, tail


def item_count(items: Env) -> int:
    for v in items.values():
        return int(v.shape[0])
    return 0
