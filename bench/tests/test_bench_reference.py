"""The plain answers a run is held to, on hand-worked cases and against
the port's own paths at CPU size."""
import numpy as np
import pytest
import torch

from bench.data.relations import make_relation
from bench.data.ssb import make_tables
from bench.reference.join import (first_match_pairs, join_pairs, pair_codes,
                                  wrong_pairs)
from bench.tests import _tiny
from bench.reference.ssb import star_answer, wrong_rows

I32 = torch.int32


def _rel(rids, keys):
    return torch.tensor(rids, dtype=I32), torch.tensor(keys, dtype=I32)


def _codes(pairs):
    return torch.tensor(sorted((p << 32) | b for p, b in pairs))


def test_join_pairs_by_hand():
    br, bk = _rel([0, 1, 2, 3], [1, 2, 2, 3])
    pr, pk = _rel([0, 1, 2, 3], [2, 3, 4, 2])
    want = _codes([(0, 1), (0, 2), (1, 3), (3, 1), (3, 2)])
    assert torch.equal(join_pairs(br, bk, pr, pk), want)
    assert torch.equal(first_match_pairs(br, bk, pr, pk),
                       _codes([(0, 1), (1, 3), (3, 1)]))


@pytest.mark.parametrize("edit, wrong", [
    (lambda c: c, 0),                                  # the answer itself
    (lambda c: c[1:], 1),                              # a pair missing
    (lambda c: torch.cat([c, c[:1]]), 1),              # a pair twice
    (lambda c: torch.cat([c[1:], c[:1] + 1]), 2),      # a pair altered
    (lambda c: c[:0], 5),                              # no answer at all
])
def test_wrong_pairs_counts_each_difference(edit, wrong):
    want = _codes([(0, 1), (0, 2), (1, 3), (3, 1), (3, 2)])
    assert wrong_pairs(torch.sort(edit(want.clone())).values, want) == wrong


def test_join_reference_matches_the_port_on_cpu():
    from repro_torch.core import phj_join
    from repro_torch.core.relation import Relation
    spec = {"rows": 1 << 12, "keys": {"dist": "uniform", "range": 1 << 12}}
    (br, bk), (pr, pk) = (make_relation(spec, "cpu", 5, side)
                          for side in ("R", "S"))
    res = phj_join(Relation(br, bk), Relation(pr, pk), max_out=1 << 15)
    c = int(res.count)
    got = pair_codes(res.probe_rid[:c], res.build_rid[:c])
    want = join_pairs(br, bk, pr, pk)
    assert want.shape[0] > 1 << 11
    assert wrong_pairs(got, want) == 0
    assert wrong_pairs(first_match_pairs(br, bk, pr, pk), want) > 0


def _star():
    fact = {"f_d": np.array([1, 2, 2, 3, 1, 9], np.int32),
            "f_e": np.array([10, 10, 11, 11, 11, 10], np.int32),
            "f_v": np.array([5, 7, 2**30, 2**30, 1, 100], np.int32)}
    dim_d = {"d_key": np.array([3, 1, 2], np.int32),
             "d_g": np.array([0, 1, 1], np.int32)}
    dim_e = {"e_key": np.array([10, 11], np.int32),
             "e_r": np.array([4, 7], np.int32)}
    return {"F": fact, "D": dim_d, "E": dim_e}


QUERY = {"tables": {"F": [], "D": [], "E": [["e_r", 0, 10]]},
         "joins": [["F", "f_d", "D", "d_key"], ["F", "f_e", "E", "e_key"]],
         "group_by": ["D.d_g", "E.e_r"], "aggregate": ["sum", "F.f_v"]}


def test_star_answer_by_hand():
    # Row 5's key 9 is in no dimension; d_g of keys 1, 2 is 1, of 3 is 0.
    assert star_answer(_star(), QUERY) == [
        (0, 7, 2**30), (1, 4, 12), (1, 7, 2**30 + 1)]
    filtered = dict(QUERY, tables={"F": [], "D": [], "E": [["e_r", 5, 10]]})
    assert star_answer(_star(), filtered) == [(0, 7, 2**30),
                                              (1, 7, 2**30 + 1)]


def test_star_control_wraps_in_int32():
    tables = _star()
    tables["F"]["f_v"][:] = 2**31 - 1
    want = star_answer(tables, QUERY)
    ctrl = star_answer(tables, QUERY, sum_dtype=np.int32)
    assert wrong_rows(ctrl, want) == 4        # two groups wrapped, both ways
    assert wrong_rows(want, want) == 0


def test_star_answer_matches_the_port_on_cpu():
    from bench.drivers.ssb_pipeline import Driver
    _, _, config, traffic = _tiny.cell("ssb_sf2.flights23")
    config["data"]["rows"] = {"lineorder": 30000, "customer": 300,
                              "supplier": 40, "part": 2000, "date": 2556}
    config["deployment"]["calibration"] = {"n": 1 << 10, "reps": 1,
                                           "delta": 0.1}
    traffic["warm_passes"] = 1
    d = Driver(config, traffic, 7, "cpu")
    d.setup()
    try:
        for name in d.order:
            q = d.queries[name]
            cols = d.executor.run(q, d.optimizer.optimize(q)).columns
            want = star_answer(d.tables, d.specs[name])
            assert want, name
            assert wrong_rows(d._answer(name, cols), want) == 0, name
    finally:
        d.release()


def test_ssb_tables_feed_every_query():
    tables = make_tables({"rows": {"lineorder": 50000, "customer": 600,
                                   "supplier": 40, "part": 4000,
                                   "date": 2556},
                          "first_date": "1992-01-01",
                          "codes": {"regions": 5, "nations_per_region": 5,
                                    "cities_per_nation": 10, "mfgrs": 5,
                                    "categories_per_mfgr": 5,
                                    "brands_per_category": 40}}, 3)
    _, _, _, traffic = _tiny.cell("ssb_sf2.flights23")
    for name, spec in traffic["queries"].items():
        assert star_answer(tables, spec), name
