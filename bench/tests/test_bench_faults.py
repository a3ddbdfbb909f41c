"""The check sees a broken program: each cell's control, and each fault a
cell can have planted under the timed path, makes ``correct`` false.

Faults (one chip, so no exchange between chips to leave out): a step that
returns its state unchanged (the previous query's answer served again),
half of the batch left out (half of the join's pairs; half of the fact
rows under the group-by), and an answer altered where it is produced (a
build rid; a group's sum)."""
import dataclasses

import numpy as np
import pytest

from bench.tests import _tiny
from repro_torch.engine.service import JoinQueryService
from repro_torch.queries.executor import PipelineExecutor

PHJ_CELLS = ["phj_paper_16m.cold", "phj_paper_16m.repeat"]


@pytest.mark.parametrize("cell", PHJ_CELLS + ["ssb_sf2.flights23"])
def test_a_sound_run_is_correct(cell):
    res = _tiny.run(cell)
    assert res["correct"] is True, res["compared"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("cell", PHJ_CELLS)
def test_join_control_is_not_correct(cell):
    res = _tiny.run(cell, control=True)
    assert res["correct"] is False
    assert res["compared"]["wrong_pairs"]["value"] > 0


def test_ssb_control_is_not_correct():
    # A window long enough for a whole cycle of the five queries, over
    # few groups (one nation, city, category and brand where SF 2 has
    # several), so at 2e5 fact rows Q2.1's and Q3.1's sums pass 2^31 as
    # they do at SF 2.
    res = _tiny.run("ssb_sf2.flights23", control=True, seconds=3.0,
                    override=_tiny.few_groups)
    assert res["correct"] is False
    assert res["compared"]["wrong_rows"]["value"] > 0


def _stale_join(orig):
    last = {}

    def run_join(self, q, *a, **kw):
        result, *rest = orig(self, q, *a, **kw)
        prev = last.get("result")
        last["result"] = result
        return (prev if prev is not None else result), *rest
    return run_join


def _half_join(orig):
    def run_join(self, q, *a, **kw):
        result, *rest = orig(self, q, *a, **kw)
        result = dataclasses.replace(
            result, count=(result.count // 2).to(result.count.dtype))
        return result, *rest
    return run_join


def _altered_join(orig):
    def run_join(self, q, *a, **kw):
        result, *rest = orig(self, q, *a, **kw)
        build = result.build_rid.clone()
        build[0] += 1
        return dataclasses.replace(result, build_rid=build), *rest
    return run_join


@pytest.mark.parametrize("cell", PHJ_CELLS)
@pytest.mark.parametrize("fault", [_stale_join, _half_join, _altered_join])
def test_join_faults_are_not_correct(monkeypatch, cell, fault):
    monkeypatch.setattr(JoinQueryService, "_run_join",
                        fault(JoinQueryService._run_join))
    res = _tiny.run(cell)
    assert res["correct"] is False, (cell, fault.__name__)


def _stale_pipeline(orig):
    last = {}

    def run(self, query, *a, **kw):
        res = orig(self, query, *a, **kw)
        prev, last["res"] = last.get("res"), res
        return prev if prev is not None else res
    return run


def _half_rows(orig):
    def run_groupby(self, q, *a, **kw):
        n = q.keys.size // 2
        from repro_torch.core.relation import Relation
        q = dataclasses.replace(q, keys=Relation(q.keys.rid[:n],
                                                 q.keys.key[:n]))
        return orig(self, q, *a, **kw)
    return run_groupby


def _altered_sum(orig):
    def run_group_by(self, query, cols, **kw):
        out, outcome = orig(self, query, cols, **kw)
        name = [c for c in out if c.startswith("~")][0]
        if len(out[name]):
            out[name] = np.array(out[name], copy=True)
            out[name][0] += 1
        return out, outcome
    return run_group_by


@pytest.mark.parametrize("target, fault", [
    ((PipelineExecutor, "run"), _stale_pipeline),
    ((JoinQueryService, "_run_groupby"), _half_rows),
    ((PipelineExecutor, "_run_group_by"), _altered_sum),
])
def test_ssb_faults_are_not_correct(monkeypatch, target, fault):
    cls, name = target
    monkeypatch.setattr(cls, name, fault(getattr(cls, name)))
    res = _tiny.run("ssb_sf2.flights23")
    assert res["correct"] is False, fault.__name__
    assert res["compared"]["wrong_rows"]["value"] > 0
