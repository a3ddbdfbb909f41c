"""Star Schema Benchmark tables (O'Neil, O'Neil, Chen, rev. 3, 2009).

Tables are dicts of int32 NumPy columns on the host, which is what
``repro_torch.queries`` takes.  Row counts come from the configuration;
the value domains follow the specification:

* every string attribute is a dense int32 code, ordered so that each
  predicate of Q2.1-Q3.4 is one half-open range: region ``r`` in [0, 5)
  (AFRICA, AMERICA, ASIA, EUROPE, MIDDLE EAST), nation ``5 r + i`` (the
  region's five nations in name order), city ``10 nation + j``; mfgr
  ``m`` in [0, 5), category ``5 m + c``, brand1 ``40 category + b``;
* keys are dense from 1; ``d_datekey`` is ``yyyymmdd`` of consecutive
  days from ``first_date``;
* ``lo_extendedprice = lo_quantity * p_retailprice`` and ``lo_revenue =
  lo_extendedprice * (100 - lo_discount) // 100``, in whole cents, with
  TPC-H's retail price formula; every value fits int32, their sums need
  int64;
* the foreign keys of lineorder are uniform over their dimension.

Each table draws from its own stream of the run's seed, in bulk.
"""
from __future__ import annotations

import numpy as np

from .relations import stream_seed

I32 = np.int32


def _rng(seed: int, table: str) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, "ssb", table))


def _geo(rng, n: int, codes: dict, prefix: str) -> dict:
    nations = codes["regions"] * codes["nations_per_region"]
    city = rng.integers(0, nations * codes["cities_per_nation"], n,
                        dtype=I32)
    nation = city // codes["cities_per_nation"]
    return {f"{prefix}_city": city, f"{prefix}_nation": nation,
            f"{prefix}_region": nation // codes["nations_per_region"]}


def retail_price_cents(partkey: np.ndarray) -> np.ndarray:
    """TPC-H's ``p_retailprice`` in cents (SSB takes it over)."""
    pk = partkey.astype(np.int64)
    return (90000 + (pk // 10) % 20001 + 100 * (pk % 1000)).astype(I32)


def make_tables(data: dict, seed: int) -> dict:
    """All five tables as ``{table: {column: int32 array}}``."""
    rows, codes = data["rows"], data["codes"]
    days = (np.datetime64(data["first_date"])
            + np.arange(rows["date"], dtype=np.int64))
    year = days.astype("datetime64[Y]").astype(np.int64) + 1970
    month = days.astype("datetime64[M]").astype(np.int64) % 12 + 1
    day = (days - days.astype("datetime64[M]")).astype(np.int64) + 1
    date = {"d_datekey": (year * 10000 + month * 100 + day).astype(I32),
            "d_year": year.astype(I32)}

    rng = _rng(seed, "customer")
    n = rows["customer"]
    customer = {"c_custkey": np.arange(1, n + 1, dtype=I32),
                **_geo(rng, n, codes, "c")}
    rng = _rng(seed, "supplier")
    n = rows["supplier"]
    supplier = {"s_suppkey": np.arange(1, n + 1, dtype=I32),
                **_geo(rng, n, codes, "s")}

    rng = _rng(seed, "part")
    n = rows["part"]
    mfgr = rng.integers(0, codes["mfgrs"], n, dtype=I32)
    category = (mfgr * codes["categories_per_mfgr"]
                + rng.integers(0, codes["categories_per_mfgr"], n, dtype=I32))
    brand1 = (category * codes["brands_per_category"]
              + rng.integers(0, codes["brands_per_category"], n, dtype=I32))
    partkey = np.arange(1, n + 1, dtype=I32)
    part = {"p_partkey": partkey, "p_mfgr": mfgr, "p_category": category,
            "p_brand1": brand1}

    rng = _rng(seed, "lineorder")
    n = rows["lineorder"]
    lo_partkey = rng.integers(1, rows["part"] + 1, n, dtype=I32)
    quantity = rng.integers(1, 51, n, dtype=I32)
    discount = rng.integers(0, 11, n, dtype=I32)
    price = retail_price_cents(partkey)[lo_partkey - 1]
    extended = quantity.astype(np.int64) * price
    lineorder = {
        "lo_orderdate": date["d_datekey"][
            rng.integers(0, rows["date"], n, dtype=I32)],
        "lo_custkey": rng.integers(1, rows["customer"] + 1, n, dtype=I32),
        "lo_partkey": lo_partkey,
        "lo_suppkey": rng.integers(1, rows["supplier"] + 1, n, dtype=I32),
        "lo_quantity": quantity,
        "lo_discount": discount,
        "lo_extendedprice": extended.astype(I32),
        "lo_revenue": (extended * (100 - discount) // 100).astype(I32),
    }
    return {"lineorder": lineorder, "date": date, "customer": customer,
            "supplier": supplier, "part": part}
