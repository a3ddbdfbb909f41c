"""Port parity for the multi-join query pipeline: ``repro_torch.queries``
against ``repro.queries`` on the same NumPy tables.  Generated tables are
equal bit for bit; plans are equal to the last float bit (the same
float64 pricing, tolerance 0); pipeline runs give equal rows,
aggregates, stage plans, cache-hit sequences, hand-off bytes, ledger
totals and cardinality records; and every result equals
``reference_execute``.

Both services run with ``num_workers=0`` and a planner that takes no
online feedback, so plans depend on the data alone."""
import dataclasses

import numpy as np
import pytest

import repro.queries as jq
import repro_torch.engine as te
import repro_torch.queries as tq

from _torch_query_cases import (PKGS, QUERIES, check, cps,  # noqa: F401
                                planner, same_query)


@pytest.mark.parametrize("name", list(QUERIES))
def test_queries_are_equal(name):
    same_query(QUERIES[name](jq), QUERIES[name](tq))


@pytest.mark.parametrize("seed", [0, 1, 17])
def test_generators_match(seed):
    for args in (dict(fact_rows=4096, dim_rows=[512, 256, 64],
                      selectivities=[0.02, None, 0.5]),
                 dict(fact_rows=300, dim_rows=[7], join_kinds=["semi"],
                      group_by=("F.g",))):
        same_query(jq.make_star_query(seed=seed, **args),
                   tq.make_star_query(seed=seed, **args))
    same_query(jq.make_chain_query([1024, 300, 64, 9], seed=seed),
               tq.make_chain_query([1024, 300, 64, 9], seed=seed))


def test_reference_helpers_match():
    for name in ("star", "variants", "grouped_multi", "grouped_outer"):
        w, g = reference_both(name)
        assert np.array_equal(g[0], w[0]) and g[1] == w[1]
    cols = tq.reference_rows(QUERIES["grouped"](tq))
    for agg in (("count",), ("sum", "F.m"), ("min", "F.m"), ("max", "F.m"),
                ("avg", "F.m"), None):
        assert tq.apply_aggregate(cols, agg) == jq.apply_aggregate(cols,
                                                                   agg)
        for wrap in (False, True):
            got = tq.apply_group_by(cols, ("F.g",), agg, wrap32=wrap)
            want = jq.apply_group_by(cols, ("F.g",), agg, wrap32=wrap)
            assert list(got) == list(want)
            assert all(np.array_equal(got[k], want[k]) for k in want)
    assert tq.NULL_VALUE == jq.NULL_VALUE and tq.JOIN_KINDS == jq.JOIN_KINDS


def reference_both(name):
    return (jq.reference_execute(QUERIES[name](jq)),
            tq.reference_execute(QUERIES[name](tq)))


# ---------------------------------------------------------------------------
# The optimizer: plans equal to the last bit.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("handoff", ["device", "host"])
@pytest.mark.parametrize("name", list(QUERIES))
def test_optimizer_plans_match(name, handoff):
    got, want = {}, {}
    for key, out in (("jax", want), ("torch", got)):
        mq, me = PKGS[key]
        pl = planner(me)
        opt = mq.JoinOrderOptimizer(pl, handoff=handoff)
        q = QUERIES[name](mq)
        out["optimize"] = opt.optimize(q).to_dict()
        out["worst"] = opt.worst_order(q).to_dict()
        out["orders"] = [[str(j) for j in o]
                         for o in opt.enumerate_orders(q)]
        out["priced"] = [opt.price_order(q, o).to_dict()
                         for o in opt.enumerate_orders(q)]
        out["stage_plans"] = [dataclasses.asdict(s.plan)
                              for s in opt.optimize(q).stages]
        greedy = mq.JoinOrderOptimizer(pl, exhaustive_joins=1,
                                       handoff=handoff)
        out["greedy"] = greedy.optimize(q).to_dict()
        # Re-pricing the tail from an observed first stage (the adaptive
        # path), at the true and at a far-off cardinality.
        if len(q.joins) >= 3:
            j0 = q.joins[0]
            out["reprice"] = [
                None if p is None else p.to_dict() for p in (
                    opt.reprice_remaining(q, [j0], list(q.joins[1:]),
                                          {id(j0): rows})
                    for rows in (1, 4096, 1 << 20))]
        out["planner"] = pl.stats()
    assert got == want


@pytest.mark.parametrize("handoff", ["device", "host"])
@pytest.mark.parametrize("name", ["star", "chain", "star_cycle",
                                  "star_empty", "variants", "grouped",
                                  "grouped_multi", "grouped_wrap",
                                  "grouped_outer"])
def test_pipeline_matches(cps, name, handoff):
    got = check(cps, name, handoff=handoff, repeats=2)
    # The second run finds its build sides resident.
    first, second = got[0], got[1]
    if first["plans"]:
        assert sum(map(any, second["hits"])) >= sum(map(any, first["hits"]))
    if handoff == "device":
        assert all(r["host_bytes_moved"] == 0 for r in got[:-1]
                   if not name.startswith("grouped_multi"))
        assert got[-1]["ledger"]["fingerprint"] == 0
        assert got[-1]["ledger"]["handoff"] == 0


@pytest.mark.parametrize("order", [1, 5])
def test_every_order_matches(cps, order):
    """Two more of the star's six join orders, fused: the same rows."""
    check(cps, "star", handoff="device", order=order)


def test_negative_keys_and_entry_points(cps):
    """Negative join keys are refused on both paths; with no card,
    ``PipelineExecutor()`` raises instead of running on the CPU."""
    import torch
    t = tq.Table("t", {"k": np.array([-6, 1, 2], dtype=np.int32)})
    u = tq.Table("u", {"k": np.array([0, 1, 2], dtype=np.int32)})
    q = tq.Query(tables={"t": t, "u": u},
                 joins=(tq.Join("t", "k", "u", "k"),))
    for handoff in ("device", "host"):
        svc = te.JoinQueryService(cp=cps["torch"], num_workers=0)
        with pytest.raises(ValueError, match="negative join-key"):
            tq.PipelineExecutor(service=svc, handoff=handoff).run(q)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tq.PipelineExecutor()
