"""SSB tables for flights 1 and 4: ``bench.data.ssb``'s tables and three
columns derived from them, with no draw of their own, so the columns
``make_tables`` gives stay what they are bit for bit.

* ``lo_supplycost = 6 * p_retailprice // 10`` of the row's part, in cents,
  as ssb-dbgen computes ``supp_cost``;
* ``d_yearmonthnum``: ``yyyymm`` of the day (Q1.2);
* ``d_weeknuminyear = (day_of_year - 1) // 7 + 1`` (Q1.3).
"""
from __future__ import annotations

import numpy as np

from . import ssb

I32 = np.int32


def make_tables(data: dict, seed: int) -> dict:
    """``bench.data.ssb.make_tables`` with the three derived columns."""
    tables = ssb.make_tables(data, seed)
    lo, date = tables["lineorder"], tables["date"]
    price = ssb.retail_price_cents(tables["part"]["p_partkey"])
    lo["lo_supplycost"] = (6 * price[lo["lo_partkey"] - 1].astype(np.int64)
                           // 10).astype(I32)
    # The date rows are consecutive days from ``first_date``.
    days = (np.datetime64(data["first_date"])
            + np.arange(date["d_datekey"].shape[0], dtype=np.int64))
    day_of_year = (days - days.astype("datetime64[Y]")).astype(np.int64) + 1
    date["d_yearmonthnum"] = date["d_datekey"] // 100
    date["d_weeknuminyear"] = ((day_of_year - 1) // 7 + 1).astype(I32)
    return tables
