"""The benchmark's inputs: SSB at SF 2 (row counts, value domains) and the
device relation generator (same seed, same bits)."""
import numpy as np
import pytest
import torch

from bench.tests import _tiny
from bench.data.relations import make_keys, make_relation, stream_seed
from bench.data.ssb import make_tables, retail_price_cents


@pytest.fixture(scope="module")
def sf2():
    _, _, config, _ = _tiny.cell("ssb_sf2.flights23")
    return config, make_tables(config["data"], 2**31 + 3)


def test_ssb_row_counts(sf2):
    config, t = sf2
    sf = config["scale_factor"]
    want = {"lineorder": 6_000_000 * sf, "customer": 30_000 * sf,
            "supplier": 2_000 * sf,
            "part": 200_000 * (1 + int(np.floor(np.log2(sf)))),
            "date": 2556}
    for name, n in want.items():
        assert config["data"]["rows"][name] == n
        assert {c.shape[0] for c in t[name].values()} == {n}, name
        assert all(c.dtype == np.int32 for c in t[name].values()), name


def test_ssb_value_domains(sf2):
    _, t = sf2
    lo, d, c, s, p = (t[k] for k in ("lineorder", "date", "customer",
                                     "supplier", "part"))
    for keys in (c["c_custkey"], s["s_suppkey"], p["p_partkey"]):
        assert np.array_equal(keys, np.arange(1, keys.shape[0] + 1))
    assert d["d_datekey"][0] == 19920101 and d["d_datekey"][-1] == 19981230
    assert np.all(np.diff(d["d_datekey"]) > 0)
    assert set(np.unique(d["d_year"])) == set(range(1992, 1999))
    assert np.array_equal(d["d_year"], d["d_datekey"] // 10000)
    for geo, pre in ((c, "c"), (s, "s")):
        city, nation, region = (geo[f"{pre}_{k}"]
                                for k in ("city", "nation", "region"))
        assert city.min() >= 0 and city.max() < 250
        assert np.array_equal(nation, city // 10)
        assert np.array_equal(region, nation // 5)
        assert set(np.unique(region)) == set(range(5))
    assert set(np.unique(p["p_mfgr"])) == set(range(5))
    assert np.array_equal(p["p_category"] // 5, p["p_mfgr"])
    assert np.array_equal(p["p_brand1"] // 40, p["p_category"])
    assert np.unique(p["p_brand1"]).shape[0] == 1000
    assert np.isin(lo["lo_orderdate"], d["d_datekey"]).all()
    for col, dim in (("lo_custkey", c["c_custkey"]),
                     ("lo_suppkey", s["s_suppkey"]),
                     ("lo_partkey", p["p_partkey"])):
        assert lo[col].min() == 1 and lo[col].max() == dim.shape[0]
    assert lo["lo_quantity"].min() == 1 and lo["lo_quantity"].max() == 50
    assert lo["lo_discount"].min() == 0 and lo["lo_discount"].max() == 10
    ext = (lo["lo_quantity"].astype(np.int64)
           * retail_price_cents(lo["lo_partkey"]))
    assert np.array_equal(lo["lo_extendedprice"], ext)
    assert np.array_equal(lo["lo_revenue"],
                          ext * (100 - lo["lo_discount"]) // 100)
    assert lo["lo_revenue"].min() > 0
    # Per row in int32; one group's sum is not.
    assert lo["lo_revenue"].astype(np.int64).sum() > 2**31


def test_retail_price_formula():
    pk = np.array([1, 10, 999, 1000, 200000])
    assert retail_price_cents(pk).tolist() == [
        90000 + 0 + 100, 90000 + 1 + 1000, 90000 + 99 + 99900,
        90000 + 100 + 0, 90000 + 20000 % 20001 + 0]


def test_ssb_same_seed_same_tables():
    _, _, config, _ = _tiny.cell("ssb_sf2.flights23")
    data = dict(config["data"], rows={"lineorder": 5000, "customer": 60,
                                      "supplier": 4, "part": 400,
                                      "date": 2556})
    a, b = make_tables(data, 9), make_tables(data, 9)
    c = make_tables(data, 10)
    for name in a:
        for col in a[name]:
            assert np.array_equal(a[name][col], b[name][col])
    assert not np.array_equal(a["lineorder"]["lo_partkey"],
                              c["lineorder"]["lo_partkey"])


@pytest.mark.parametrize("keys", [
    {"dist": "uniform", "range": 1 << 20},
    {"dist": "unique"},
    {"dist": "zipf", "range": 1 << 12, "s": 1.0},
])
def test_relation_same_seed_same_bits(keys):
    spec = {"rows": 1 << 14, "keys": keys}
    seed = 2**33 + 1
    rid, a = make_relation(spec, "cpu", seed, "query", 3, "R")
    _, b = make_relation(spec, "cpu", seed, "query", 3, "R")
    _, c = make_relation(spec, "cpu", seed, "query", 4, "R")
    _, d = make_relation(spec, "cpu", seed + 1, "query", 3, "R")
    assert a.dtype == torch.int32 and torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)
    assert torch.equal(rid, torch.arange(1 << 14, dtype=torch.int32))
    hi = keys.get("range", 1 << 14)
    assert int(a.min()) >= 0 and int(a.max()) < hi
    if keys["dist"] == "unique":
        assert torch.equal(torch.sort(a).values, rid)


def test_zipf_keys_are_skewed():
    keys = make_keys({"dist": "zipf", "range": 1 << 12, "s": 1.0}, 1 << 16,
                     "cpu", 1, "z")
    counts = torch.bincount(keys.long()).sort(descending=True).values
    # Rank 1 holds about 1 / H(4096) (11.5 %) of the draws.
    assert 0.09 < float(counts[0]) / (1 << 16) < 0.14


def test_stream_seeds_differ_by_stream_and_fit_63_bits():
    s = {stream_seed(2**31 + 5, *st) for st in
         [("query", 0), ("query", 1), ("pool", 0), ("warm", 0), ()]}
    assert len(s) == 5 and all(0 <= x < 2**63 for x in s)
