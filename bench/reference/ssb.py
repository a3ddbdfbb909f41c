"""Plain NumPy answer of a star query: filters, joins, group-by, sum.

A query spec is the JSON object a traffic file holds: ``tables`` maps
each table to its range filters ``[column, lo, hi]`` (``lo <= v < hi``),
``joins`` lists ``[fact, fact_column, dim, dim_key]`` edges, ``group_by``
lists qualified ``table.column`` names and ``aggregate`` is ``["sum",
"table.column"]``.  Every edge starts at the one fact table and ends at a
dimension key that is unique in its table, as in SSB.

The answer is one row per group: the group's key values and its sum, as a
sorted list of tuples.  Sums are exact int64; ``sum_dtype=np.int32`` is
the control, the same answer summed in int32 with wrap-around.
Nothing of the program under test is imported.
"""
from __future__ import annotations

from collections import Counter

import numpy as np


def _mask(cols: dict, filters) -> np.ndarray:
    n = next(iter(cols.values())).shape[0]
    keep = np.ones(n, dtype=bool)
    for col, lo, hi in filters:
        v = cols[col]
        keep &= (v >= lo) & (v < hi)
    return keep


def _lookup(keys: np.ndarray) -> np.ndarray:
    """Row of each key value (-1 where none); keys must be unique."""
    if np.unique(keys).shape[0] != keys.shape[0]:
        raise ValueError("a dimension key is not unique")
    table = np.full(int(keys.max()) + 1, -1, dtype=np.int64)
    table[keys] = np.arange(keys.shape[0])
    return table


def star_answer(tables: dict, query: dict, *, sum_dtype=np.int64) -> list:
    """Sorted ``(group values..., sum)`` tuples of ``query`` over
    ``tables`` (``{table: {column: array}}``)."""
    fact = query["joins"][0][0]
    fcols = tables[fact]
    keep = _mask(fcols, query["tables"].get(fact, ()))
    dim_rows = {}
    for f, fcol, dim, dkey in query["joins"]:
        if f != fact:
            raise ValueError("not a star: every edge must start at the fact")
        dcols = tables[dim]
        row = _lookup(dcols[dkey])
        fk = fcols[fcol].astype(np.int64)
        r = np.where((fk >= 0) & (fk < row.shape[0]),
                     row[np.clip(fk, 0, row.shape[0] - 1)], -1)
        ok = r >= 0
        ok[ok] &= _mask(dcols, query["tables"].get(dim, ()))[r[ok]]
        keep &= ok
        dim_rows[dim] = r
    sel = np.nonzero(keep)[0]

    def column(qual: str) -> np.ndarray:
        table, _, col = qual.partition(".")
        if table == fact:
            return fcols[col][sel]
        return tables[table][col][dim_rows[table][sel]]

    kind, agg_col = query["aggregate"]
    if kind != "sum":
        raise ValueError(f"unsupported aggregate {kind!r}")
    keys = np.stack([column(q).astype(np.int64) for q in query["group_by"]],
                    axis=1)
    groups, inv = np.unique(keys, axis=0, return_inverse=True)
    sums = np.zeros(groups.shape[0], dtype=sum_dtype)
    np.add.at(sums, inv.reshape(-1), column(agg_col).astype(sum_dtype))
    return sorted(tuple(int(v) for v in g) + (int(s),)
                  for g, s in zip(groups, sums))


def wrong_rows(got: list, want: list) -> int:
    """Rows of the multiset difference of two answers, both ways."""
    a, b = Counter(got), Counter(want)
    return sum(((a - b) + (b - a)).values())
