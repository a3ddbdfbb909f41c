"""Plain PyTorch answer of an SSB star query, flights 1 to 4: range
filters, joins on unique dimension keys, group-by, and the sum of a
column or of a binary expression of two.

A query spec is the JSON object a traffic file holds: ``tables`` maps
each table to its range filters ``[column, lo, hi]`` (``lo <= v < hi``),
``joins`` lists ``[fact, fact_column, dim, dim_key]`` edges that all start
at one fact table, ``group_by`` lists qualified ``table.column`` names
(none for a scalar query) and ``aggregate`` is ``["sum", operand]`` with
the operand a ``"table.column"`` or ``[op, "t.a", "u.b"]``, ``op`` one of
``+``, ``-``, ``*``.

Everything is computed on the CPU in int64 tensors: a dimension row is
found by ``searchsorted`` over its sorted keys.  The answer is one
``(group values..., sum)`` tuple per group, sorted; a scalar query's is
``[(sum,)]``.  ``wrap32=True`` is the control: the same sums wrapped to
int32.  Nothing of the program under test is imported.
"""
from __future__ import annotations

import torch

I64 = torch.int64


def _col(tables: dict, table: str, col: str) -> torch.Tensor:
    return torch.as_tensor(tables[table][col]).to(I64)


def _keep(tables: dict, table: str, filters) -> torch.Tensor:
    n = len(next(iter(tables[table].values())))
    keep = torch.ones(n, dtype=torch.bool)
    for col, lo, hi in filters:
        v = _col(tables, table, col)
        keep &= (v >= lo) & (v < hi)
    return keep


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def star_answer(tables: dict, query: dict, *, wrap32: bool = False) -> list:
    """Sorted answer tuples of ``query`` over ``tables``
    (``{table: {column: array}}``)."""
    fact = query["joins"][0][0]
    keep = _keep(tables, fact, query["tables"].get(fact, ()))
    dim_row = {}
    for f, fcol, dim, dkey in query["joins"]:
        if f != fact:
            raise ValueError("not a star: every edge must start at the fact")
        keys, order = torch.sort(_col(tables, dim, dkey))
        if bool((keys[1:] == keys[:-1]).any()):
            raise ValueError(f"{dim}.{dkey} is not unique")
        fk = _col(tables, fact, fcol)
        pos = torch.searchsorted(keys, fk).clamp(max=keys.shape[0] - 1)
        row = order[pos]
        keep &= (keys[pos] == fk) & _keep(
            tables, dim, query["tables"].get(dim, ()))[row]
        dim_row[dim] = row
    sel = torch.nonzero(keep).squeeze(1)

    def column(qual: str) -> torch.Tensor:
        table, _, col = qual.partition(".")
        rows = sel if table == fact else dim_row[table][sel]
        return _col(tables, table, col)[rows]

    kind, operand = query["aggregate"]
    if kind != "sum":
        raise ValueError(f"unsupported aggregate {kind!r}")
    if isinstance(operand, str):
        values = column(operand)
    else:
        op, a, b = operand
        x, y = column(a), column(b)
        values = {"+": x + y, "-": x - y, "*": x * y}[op]
    if wrap32:
        values = _wrap32(values)
    group_by = list(query["group_by"])
    if not group_by:
        total = values.sum()
        return [(int(_wrap32(total) if wrap32 else total),)]
    keys = torch.stack([column(q) for q in group_by], dim=1)
    groups, inv = torch.unique(keys, dim=0, return_inverse=True)
    sums = torch.zeros(groups.shape[0], dtype=I64).index_add_(0, inv, values)
    if wrap32:
        sums = _wrap32(sums)
    return sorted(tuple(int(v) for v in g) + (int(s),)
                  for g, s in zip(groups.tolist(), sums.tolist()))
