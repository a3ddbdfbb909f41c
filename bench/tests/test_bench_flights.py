"""The ``ssb_sf2.flights14`` cell on the CPU: its data (flights 2-3's
tables unchanged, three derived columns), its plain reference (by hand,
and against ``bench/reference/ssb.py`` where the sum is a bare column),
a sound run (``correct``), its control (not ``correct``), and the
executor readers on a program that records none of their spans."""
import types

import numpy as np
import pytest

from bench import harness
from bench.data import ssb, ssb_flights
from bench.records import Readings
from bench.reference import ssb as ssb_ref
from bench.reference.ssb_flights import star_answer
from bench.tests import _tiny

CELL = "ssb_sf2.flights14"
READERS = ("executor.sink_ms", "executor.scan_fp_ms",
           "executor.scan_upload_MB_per_query")


def _data(lineorder=30000):
    _, _, config, _ = harness.cell_spec(CELL)
    config["data"]["rows"]["lineorder"] = lineorder
    return config["data"]


def test_the_derived_columns_leave_the_tables_as_they_were():
    data = _data()
    base, more = ssb.make_tables(data, 2**33 + 1), \
        ssb_flights.make_tables(data, 2**33 + 1)
    assert list(base) == list(more)
    for table, cols in base.items():
        for col, v in cols.items():
            assert more[table][col].dtype == v.dtype == np.int32
            assert np.array_equal(more[table][col], v), (table, col)
    added = {t: sorted(set(more[t]) - set(base[t])) for t in base}
    assert added == {"lineorder": ["lo_supplycost"],
                     "date": ["d_weeknuminyear", "d_yearmonthnum"],
                     "customer": [], "supplier": [], "part": []}


def test_the_derived_columns_by_hand():
    t = ssb_flights.make_tables(_data(1000), 3)
    date, lo = t["date"], t["lineorder"]
    at = {int(k): i for i, k in enumerate(date["d_datekey"])}
    for key, ym, week in ((19920101, 199201, 1), (19920107, 199201, 1),
                          (19920108, 199201, 2), (19920229, 199202, 9),
                          (19921231, 199212, 53), (19940204, 199402, 5),
                          (19940211, 199402, 6), (19981230, 199812, 52)):
        assert date["d_yearmonthnum"][at[key]] == ym, key
        assert date["d_weeknuminyear"][at[key]] == week, key
    price = ssb.retail_price_cents(lo["lo_partkey"])
    assert np.array_equal(lo["lo_supplycost"],
                          (6 * price.astype(np.int64) // 10))
    assert np.array_equal(lo["lo_extendedprice"],
                          lo["lo_quantity"].astype(np.int64) * price)


def test_the_reference_by_hand():
    tables = {"F": {"d": np.array([1, 2, 2, 3, 9], np.int32),
                    "x": np.array([2**31 - 1, 3, -4, 5, 100], np.int32),
                    "y": np.array([2**31 - 1, 2, 7, -6, 100], np.int32)},
              "D": {"k": np.array([3, 1, 2], np.int32),
                    "g": np.array([0, 1, 1], np.int32)}}
    q = {"tables": {"F": [["x", -10, 2**31 - 1]], "D": []},
         "joins": [["F", "d", "D", "k"]], "group_by": ["D.g"],
         "aggregate": ["sum", ["*", "F.x", "F.y"]]}
    # Row 0 is filtered out, row 4's key 9 is in no dimension.
    assert star_answer(tables, q) == [(0, -30), (1, 6 - 28)]
    q["tables"]["F"] = []
    assert star_answer(tables, dict(q, group_by=[])) == [
        ((2**31 - 1)**2 + 6 - 28 - 30,)]
    assert star_answer(tables, dict(q, group_by=[], aggregate=[
        "sum", ["-", "F.x", "F.y"]])) == [(0 + 1 - 11 + 11,)]
    wrapped = star_answer(tables, dict(q, group_by=[]), wrap32=True)
    assert wrapped == [(((2**31 - 1)**2 + 6 - 28 - 30 + 2**31) % 2**32
                        - 2**31,)]


def test_the_reference_agrees_with_flights_23s():
    tables = ssb_flights.make_tables(_data(), 5)
    _, _, _, traffic = _tiny.cell(_tiny.SSB)
    for name, spec in traffic["queries"].items():
        want = ssb_ref.star_answer(tables, spec)
        assert want, name
        assert star_answer(tables, spec) == want, name
        assert star_answer(tables, spec, wrap32=True) == \
            ssb_ref.star_answer(tables, spec, sum_dtype=np.int32), name


def test_every_flights14_query_has_an_answer():
    tables = ssb_flights.make_tables(_data(60000), 7)
    _, _, _, traffic = harness.cell_spec(CELL)
    assert traffic["order"] == ["q1.1", "q1.2", "q1.3", "q4.1", "q4.2",
                                "q4.3"]
    for name, spec in traffic["queries"].items():
        got = star_answer(tables, spec)
        assert got and all(row[-1] != 0 for row in got), name
        if name.startswith("q4"):
            assert len(spec["joins"]) == 4 and len(got) > 1, name


def test_a_sound_run_is_correct():
    res = _tiny.run(CELL, seconds=2.0)
    assert res["correct"] is True, res["compared"]
    assert res["failed"] == 0 and res["attempted"] >= 6


def _more_rows(config, traffic):
    # Enough fact rows that Q1.x's sums pass 2^31, as they do at SF 2.
    config["data"]["rows"]["lineorder"] = 200_000


def test_control_is_not_correct():
    res = _tiny.run(CELL, control=True, seconds=3.0, override=_more_rows)
    assert res["correct"] is False
    assert res["compared"]["wrong_rows"]["value"] > 0


def test_a_traced_run_reads_the_executor_metrics():
    res = _tiny.run(CELL, trace=True)
    assert res["correct"] is True, res["compared"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(m) == set(READERS) | {"optimizer.optimize_ms",
                                     "executor.self_ms"}
    assert all(v > 0 for v in m.values()), m


def test_without_the_spans_the_readers_read_nothing():
    """A program with no ``sink`` or ``scan.fp`` span and no
    ``scan_upload`` cause (the parent's): every new reader returns
    None."""
    span = types.SimpleNamespace(name="query", t0=0.0, t1=1.0, lane=None,
                                 thread="w", attrs={"q_key": 1})
    query = types.SimpleNamespace(spans={"run": (0.0, 2.0)})
    r = Readings([query], [span], {"fingerprint": 0, "result": 8}, {}, {})
    for metric in READERS:
        assert harness.reader(metric)(r) is None, metric


@pytest.mark.parametrize("metric, want", [
    ("executor.sink_ms", 1e3 * (0.25 + 0.5) / 2),
    ("executor.scan_fp_ms", 1e3 * (0.125 + 0.125 + 0.25) / 2),
    ("executor.scan_upload_MB_per_query", 3.0)])
def test_the_readers_by_hand(metric, want):
    def span(name, t0, t1):
        return types.SimpleNamespace(name=name, t0=t0, t1=t1, lane=None,
                                     thread="w", attrs={})
    spans = [span("sink", 0.0, 0.25), span("sink", 1.0, 1.5),
             span("scan.fp", 0.0, 0.125), span("scan.fp", 0.5, 0.625),
             span("scan.fp", 1.0, 1.25)]
    r = Readings([object(), object()], spans, {"scan_upload": 6_000_000},
                 {}, {})
    assert harness.reader(metric)(r) == pytest.approx(want)
