"""Logical-plan IR for multi-join queries (star / snowflake / chain shapes).

The engine executes one binary join per request; real analytical queries
chain several equi-joins over filtered base tables and end in an
aggregation.  This module is the *declarative* layer: named tables with
integer columns, selectivity-annotated range filters, a set of equi-join
edges, and an optional count/sum sink (of a column, or of a binary
arithmetic expression of two columns).  ``optimize.py`` turns a ``Query``
into a physical stage pipeline; ``executor.py`` runs it through the
engine.

Conventions:

  * columns are int32 NumPy arrays of equal length per table (the paper's
    4-byte-integer columnar layout, widened to many columns);
  * a row's identity is its position — join stages build core
    ``Relation``s with ``rid = arange(n)``, so match indices gather
    payload columns directly (``Relation.gather``'s convention);
  * qualified column names are ``"table.column"``; intermediates carry the
    union of their inputs' qualified columns.

A NumPy reference implementation (``reference_rows`` /
``reference_execute``) folds the joins in textual order; every physical
plan, whatever join order the optimizer picked, must reproduce exactly its
row multiset — that is the permutation-invariance contract the tests and
the ``query_pipeline`` benchmark enforce.

A copy of ``repro/queries/plan.py`` (NumPy only), so the port loads none
of the JAX package, with two additions of the port's: a sum over an
expression (``EXPR_OPS``), and each column's range memoized on its
``Table`` (``Table.column_range``), which gives the optimizer the same
floats from one scan of the column.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Filter:
    """Range predicate ``lo <= col < hi`` with a selectivity annotation.

    ``selectivity`` is the optimizer's estimate of the surviving fraction;
    when omitted it is estimated from the column's observed min/max under a
    uniformity assumption (the classic System-R default).
    """

    column: str
    lo: int
    hi: int
    selectivity: float | None = None

    def mask(self, col: np.ndarray) -> np.ndarray:
        return (col >= self.lo) & (col < self.hi)

    def estimate(self, col: np.ndarray) -> float:
        return self.estimate_range(
            None if self.selectivity is not None else value_range(col))

    def estimate_range(self, span: tuple[int, int] | None) -> float:
        """The estimate over a column whose observed range is ``span`` =
        ``(min, max + 1)``, ``None`` for an empty one; the annotation, when
        given, takes precedence and ``span`` is not read."""
        if self.selectivity is not None:
            return float(min(max(self.selectivity, 0.0), 1.0))
        if span is None:
            return 1.0
        lo, hi = span
        width = max(1, hi - lo)
        covered = max(0, min(self.hi, hi) - max(self.lo, lo))
        return min(1.0, covered / width)


def value_range(col: np.ndarray) -> tuple[int, int] | None:
    """``(min, max + 1)`` of ``col``, or ``None`` when it is empty."""
    if col.size == 0:
        return None
    return int(col.min()), int(col.max()) + 1


class Table:
    """A named base table: equal-length int32 columns plus scan filters.

    The optimizer's statistics (each column's range and distinct count)
    and the executor's scan (``filtered``, ``scan_indices``) are memoized
    on first use, so a column is not changed in place once the table has
    been used.  A table made by ``with_filters`` starts with no memo.
    """

    def __init__(self, name: str, columns: dict, filters=()):
        self.name = name
        self.columns = {c: np.asarray(v, dtype=np.int32)
                        for c, v in columns.items()}
        sizes = {v.shape[0] for v in self.columns.values()}
        if len(sizes) != 1:
            raise ValueError(f"ragged columns in table {name!r}: {sizes}")
        self.filters = tuple(filters)
        self._filtered: "Table | None" = None
        self._scan_idx: np.ndarray | None = None
        self._ndv: dict[str, int] = {}
        self._range: dict[str, tuple[int, int] | None] = {}
        self._range_scans = self._range_hits = 0

    @property
    def size(self) -> int:
        return next(iter(self.columns.values())).shape[0]

    def with_filters(self, *filters: Filter) -> "Table":
        return Table(self.name, self.columns, self.filters + tuple(filters))

    # -- executor side: actual data -----------------------------------------
    def filtered(self) -> "Table":
        """The table with its filters applied (memoized; no filters = self)."""
        if not self.filters:
            return self
        if self._filtered is None:
            mask = np.ones(self.size, dtype=bool)
            for f in self.filters:
                mask &= f.mask(self.columns[f.column])
            self._filtered = Table(
                self.name, {c: v[mask] for c, v in self.columns.items()})
        return self._filtered

    def qualified(self) -> dict:
        """Filtered columns under their qualified ``table.column`` names."""
        t = self.filtered()
        return {f"{self.name}.{c}": v for c, v in t.columns.items()}

    def scan_indices(self) -> np.ndarray | None:
        """Surviving row indices under the filters (memoized), or ``None``
        when unfiltered.

        This is the fused scan path: the executor composes this index
        directly into the gathers that consume the table instead of
        materializing every filtered column up front (``filtered()``
        stays for the NumPy reference).
        """
        if not self.filters:
            return None
        if self._scan_idx is None:
            mask = np.ones(self.size, dtype=bool)
            for f in self.filters:
                mask &= f.mask(self.columns[f.column])
            self._scan_idx = np.nonzero(mask)[0]
        return self._scan_idx

    # -- optimizer side: estimates only -------------------------------------
    def est_rows(self) -> float:
        """Estimated post-filter cardinality (annotations, or each filtered
        column's memoized range)."""
        est = float(self.size)
        for f in self.filters:
            est *= f.estimate_range(None if f.selectivity is not None
                                    else self.column_range(f.column))
        return max(1.0, est)

    def column_range(self, column: str) -> tuple[int, int] | None:
        """``value_range`` of ``column``, scanned once per table."""
        if column in self._range:
            self._range_hits += 1
        else:
            self._range_scans += 1
            self._range[column] = value_range(self.columns[column])
        return self._range[column]

    def stats(self) -> dict:
        """Range-memo misses (column scans) and hits so far."""
        return {"range_scans": self._range_scans,
                "range_hits": self._range_hits}

    def ndv_est(self, column: str) -> float:
        """Estimated distinct values of ``column`` after filtering.

        Exact distinct count on the unfiltered column (cheap, memoized),
        capped by the estimated surviving rows — filtering a uniform
        fraction keeps at most that many distinct values.
        """
        if column not in self._ndv:
            self._ndv[column] = int(np.unique(self.columns[column]).size)
        return max(1.0, min(float(self._ndv[column]), self.est_rows()))


JOIN_KINDS = ("inner", "semi", "anti", "left_outer")

# SQL NULL for the int32 column model: the right side of an unmatched
# left-outer row.  Join keys are validated non-negative, so the sentinel
# never collides with a real key (payload columns may hold any value the
# user put there; -1 payloads are indistinguishable from NULL by design).
NULL_VALUE = -1

# Binary operators of an aggregate expression ``(op, "t.a", "u.b")``: the
# two int32 columns are widened to int64 first, so the value is exact.
EXPR_OPS = ("+", "-", "*")


def evaluate(operand, column):
    """The operand's int64 values; ``column(q)`` returns column ``q``
    widened to int64 (a NumPy array or a tensor: the operators are the
    same)."""
    if isinstance(operand, str):
        return column(operand)
    op, a, b = operand
    x, y = column(a), column(b)
    return x + y if op == "+" else x - y if op == "-" else x * y


@dataclasses.dataclass(frozen=True)
class Join:
    """One join edge: ``left.left_col == right.right_col``.

    ``kind`` selects the variant semantics:

      * ``inner``      — all matching row pairs (the default).
      * ``semi``       — left rows with ≥ 1 match; the right table is a
                         pure filter (its columns are consumed, and it may
                         appear in no other edge / group-by / aggregate).
      * ``anti``       — left rows with 0 matches; same right-side rules.
      * ``left_outer`` — all matching pairs plus unmatched left rows with
                         the right columns ``NULL_VALUE``-filled.
    """

    left: str
    left_col: str
    right: str
    right_col: str
    kind: str = "inner"

    @property
    def left_q(self) -> str:
        return f"{self.left}.{self.left_col}"

    @property
    def right_q(self) -> str:
        return f"{self.right}.{self.right_col}"

    def __str__(self) -> str:
        op = {"inner": "=", "semi": "⋉", "anti": "▷",
              "left_outer": "⟕"}.get(self.kind, "=")
        return f"{self.left_q}{op}{self.right_q}"


@dataclasses.dataclass
class Query:
    """A declarative multi-join query: tables, join edges, optional sink.

    ``joins`` in textual order is the naive left-deep baseline the
    optimizer must never price worse than.  ``aggregate`` is ``None``
    (return the joined rows), ``("count",)``, ``("<agg>",
    "table.column")`` with ``<agg>`` in sum/min/max/avg, or ``("sum",
    (op, "t.a", "u.b"))``: the exact int64 sum of ``a op b`` with ``op``
    in ``EXPR_OPS`` (Q1.x's ``lo_extendedprice * lo_discount``).

    ``group_by`` names qualified key columns: the sink then aggregates per
    distinct key combination (default ``("count",)`` when no aggregate is
    given) and the query's result is one row per group.  Grouped sums
    (and the avg numerator) accumulate wide — exact int64 via the
    segmented-agg kernel's chunked channels — unless ``wrap32=True``
    requests the legacy int32-wrapping device accumulator (kept for
    oracle-parity tests, column sums only); the NumPy reference
    reproduces either mode exactly.  Scalar sinks are exact int64.
    """

    tables: dict
    joins: tuple
    aggregate: tuple | None = None
    group_by: tuple = ()
    wrap32: bool = False

    def _check_column_ref(self, ref: str, what: str):
        tbl, _, col = ref.partition(".")
        if (not col or tbl not in self.tables
                or col not in self.tables[tbl].columns):
            raise ValueError(f"{what} over unknown column {ref!r}")

    def __post_init__(self):
        self.joins = tuple(self.joins)
        self.group_by = tuple(self.group_by)
        for j in self.joins:
            for side, col in ((j.left, j.left_col), (j.right, j.right_col)):
                if side not in self.tables:
                    raise ValueError(f"join {j} references unknown table "
                                     f"{side!r}")
                if col not in self.tables[side].columns:
                    raise ValueError(f"join {j}: no column {col!r} on "
                                     f"{side!r}")
            if j.kind not in JOIN_KINDS:
                raise ValueError(f"unknown join kind {j.kind!r}")
            if j.kind != "inner" and j.left == j.right:
                raise ValueError(f"join {j}: cycle/self edges must be "
                                 f"inner (they are residual filters)")
        # Semi/anti right sides are pure filter tables: consumed by the
        # edge, so nothing downstream may reference their columns.
        self._consumed = tuple(j.right for j in self.joins
                               if j.kind in ("semi", "anti"))
        for j in self.joins:
            if j.kind not in ("semi", "anti"):
                continue
            uses = sum(1 for k in self.joins
                       if j.right in (k.left, k.right))
            if uses > 1:
                raise ValueError(
                    f"{j.kind} join {j}: filter table {j.right!r} may "
                    f"appear in no other join edge")
        # A left-outer edge NULL-pads its right table's columns; a later
        # join keyed on them would carry NULL_VALUE (-1) keys, which the
        # executor (correctly) refuses — reject at construction instead.
        # Outer queries execute in textual order, so "later" is textual;
        # edges BEFORE the outer join see the table pre-padding and are
        # fine (snowflake under an outer fact edge).
        for i, j in enumerate(self.joins):
            if j.kind != "left_outer":
                continue
            for k in self.joins[i + 1:]:
                if j.right in (k.left, k.right):
                    raise ValueError(
                        f"join {k} references {j.right!r} after left-outer "
                        f"join {j} NULL-padded its columns; joins on "
                        f"nullable columns are unsupported")
        for q in self.group_by:
            self._check_column_ref(q, "group_by")
            if q.partition(".")[0] in self._consumed:
                raise ValueError(f"group_by column {q!r} references a "
                                 f"semi/anti-consumed table")
        if self.aggregate is not None:
            kind = self.aggregate[0]
            if kind not in ("count", "sum", "min", "max", "avg"):
                raise ValueError(f"unknown aggregate {kind!r}")
            if kind != "count":
                operand = self.aggregate[1]
                if not isinstance(operand, str):
                    if (not isinstance(operand, tuple) or len(operand) != 3
                            or operand[0] not in EXPR_OPS):
                        raise ValueError(
                            f"{kind} operand {operand!r} is neither a "
                            f"column nor (op, column, column) with op in "
                            f"{EXPR_OPS}")
                    if kind != "sum":
                        raise ValueError(f"{kind} over an expression is "
                                         f"unsupported: only sum takes one")
                    if self.wrap32:
                        raise ValueError("wrap32 applies to column sums, "
                                         "not to an expression's")
                refs = (operand,) if isinstance(operand, str) else \
                    operand[1:]
                for ref in refs:
                    self._check_column_ref(ref, kind)
                    if ref.partition(".")[0] in self._consumed:
                        raise ValueError(f"{kind} column {ref!r} references "
                                         f"a semi/anti-consumed table")
        # The join graph must connect every table: a disconnected query
        # would need a cross product no stage expresses (the NumPy oracle
        # rejects it too, but at execution time — fail at construction).
        if len(self.tables) > 1:
            reached = {next(iter(self.tables))}
            frontier = True
            while frontier:
                frontier = False
                for j in self.joins:
                    if (j.left in reached) != (j.right in reached):
                        reached.update((j.left, j.right))
                        frontier = True
            missing = set(self.tables) - reached
            if missing:
                raise ValueError(f"join graph is disconnected: "
                                 f"{sorted(missing)} unreachable")

    def describe(self) -> str:
        parts = [f"{n}({t.size}{'σ' if t.filters else ''})"
                 for n, t in self.tables.items()]
        joins = " ⋈ ".join(str(j) for j in self.joins)
        gb = f" group by {list(self.group_by)}" if self.group_by else ""
        agg = f" -> {self.aggregate}" if self.aggregate else ""
        return f"[{', '.join(parts)}] {joins}{gb}{agg}"


# ---------------------------------------------------------------------------
# NumPy reference (textual join order) — the correctness oracle.
# ---------------------------------------------------------------------------

def _np_equijoin(left_cols: dict, right_cols: dict, left_q: str,
                 right_q: str) -> dict:
    """All matching row pairs of two qualified column sets (sort-merge)."""
    lk = left_cols[left_q].astype(np.int64)
    rk = right_cols[right_q].astype(np.int64)
    order = np.argsort(rk, kind="stable")
    rk_sorted = rk[order]
    lo = np.searchsorted(rk_sorted, lk, side="left")
    hi = np.searchsorted(rk_sorted, lk, side="right")
    counts = hi - lo
    total = int(counts.sum())
    li = np.repeat(np.arange(lk.size), counts)
    # For row i of the left side, its matches are order[lo[i]:hi[i]]:
    # vectorized as lo repeated per match plus a within-group ramp.
    offsets = np.concatenate([[0], np.cumsum(counts)])
    within = np.arange(total) - np.repeat(offsets[:-1], counts)
    ri = order[np.repeat(lo, counts) + within]
    out = {q: v[li] for q, v in left_cols.items()}
    out.update({q: v[ri] for q, v in right_cols.items()})
    return out


def _np_left_outer(left_cols: dict, right_cols: dict, left_q: str,
                   right_q: str) -> dict:
    """Inner pairs plus NULL-padded unmatched left rows."""
    lk = left_cols[left_q].astype(np.int64)
    rk = right_cols[right_q].astype(np.int64)
    order = np.argsort(rk, kind="stable")
    rk_sorted = rk[order]
    lo = np.searchsorted(rk_sorted, lk, side="left")
    hi = np.searchsorted(rk_sorted, lk, side="right")
    counts = hi - lo
    eff = np.maximum(counts, 1)               # unmatched rows emit once
    total = int(eff.sum())
    li = np.repeat(np.arange(lk.size), eff)
    offsets = np.concatenate([[0], np.cumsum(eff)])
    within = np.arange(total) - np.repeat(offsets[:-1], eff)
    matched = np.repeat(counts > 0, eff)
    ri = np.where(matched,
                  order[np.minimum(np.repeat(lo, eff) + within,
                                   max(rk.size - 1, 0))]
                  if rk.size else 0, 0)
    out = {q: v[li] for q, v in left_cols.items()}
    for q, v in right_cols.items():
        vals = v[ri] if v.shape[0] else np.zeros(total, v.dtype)
        out[q] = np.where(matched, vals, v.dtype.type(NULL_VALUE))
    return out


def reference_rows(query: Query) -> dict:
    """Fold the joins in textual order over filtered tables (pure NumPy)."""
    if not query.joins and len(query.tables) == 1:
        return next(iter(query.tables.values())).qualified()
    joined: dict[str, dict] = {}   # table name -> its current component cols
    absorbed: set[str] = set()     # semi/anti filter tables (consumed)

    def component_of(name: str) -> dict:
        if name not in joined:
            joined[name] = query.tables[name].qualified()
        return joined[name]

    for j in query.joins:
        left = component_of(j.left)
        if j.kind in ("semi", "anti"):
            # The right side is a validated pure filter table: keep left
            # rows by key membership, consume the table.
            right = query.tables[j.right].qualified()
            keep = np.isin(left[j.left_q], right[j.right_q])
            if j.kind == "anti":
                keep = ~keep
            merged = {q: v[keep] for q, v in left.items()}
            absorbed.add(j.right)
            for name, comp in list(joined.items()):
                if comp is left:
                    joined[name] = merged
            joined[j.right] = merged   # reachable, but contributes no cols
            continue
        right = component_of(j.right)
        if left is right:
            # Cycle edge within one component: a residual filter.
            merged = {q: v[left[j.left_q] == left[j.right_q]]
                      for q, v in left.items()}
        elif j.kind == "left_outer":
            merged = _np_left_outer(left, right, j.left_q, j.right_q)
        else:
            merged = _np_equijoin(left, right, j.left_q, j.right_q)
        for name, comp in list(joined.items()):
            if comp is left or comp is right:
                joined[name] = merged
    if not joined:
        return {}
    final = joined[query.joins[-1].left]
    if any(comp is not final for comp in joined.values()):
        raise ValueError("query's join graph is disconnected")
    return final


def rows_array(columns: dict) -> np.ndarray:
    """Canonical sorted (n, k) row array over sorted column names.

    Two executions are equivalent iff their ``rows_array`` outputs are
    identical — row order and column order are both normalized away.
    int64 unless a column is floating (grouped ``avg``), then float64 —
    both sides of a comparison compute the identical float64 division, so
    exact equality still holds.
    """
    names = sorted(columns)
    if not names:
        return np.empty((0, 0), dtype=np.int64)
    dtype = (np.float64 if any(np.issubdtype(columns[c].dtype, np.floating)
                               for c in names) else np.int64)
    mat = np.stack([columns[c].astype(dtype) for c in names], axis=1)
    return mat[np.lexsort(tuple(mat[:, k] for k in range(mat.shape[1] - 1,
                                                         -1, -1)))]


def apply_aggregate(columns: dict, aggregate: tuple | None):
    """Scalar sink over joined rows (host-side, int64-exact)."""
    if aggregate is None:
        return None
    kind = aggregate[0]
    if kind == "count":
        return int(next(iter(columns.values())).shape[0]) if columns else 0
    col = evaluate(aggregate[1], lambda q: columns[q].astype(np.int64))
    if col.size == 0:
        return None if kind in ("min", "max", "avg") else 0
    if kind == "sum":
        return int(col.sum())
    if kind == "min":
        return int(col.min())
    if kind == "max":
        return int(col.max())
    return float(col.sum()) / col.size          # avg


def agg_output_name(aggregate: tuple) -> str:
    """Qualified name of the aggregate's output column in a grouped
    result (sorts after any ``table.column`` name, which keeps group keys
    leading in ``rows_array``'s canonical column order): ``~sum(t.a*u.b)``
    for an expression."""
    if aggregate[0] == "count":
        return "~count()"
    operand = aggregate[1]
    if not isinstance(operand, str):
        operand = f"{operand[1]}{operand[0]}{operand[2]}"
    return f"~{aggregate[0]}({operand})"


def apply_group_by(columns: dict, group_by: tuple,
                   aggregate: tuple | None, wrap32: bool = False) -> dict:
    """Grouped aggregation over joined rows (the oracle's sink).

    Returns the group-key columns plus one aggregate column (named by
    ``agg_output_name``).  Count/min/max are int32; sums are exact int64
    (the wide device accumulator's semantics) unless ``wrap32=True``
    reproduces the legacy int32 wrap; avg is float64 of the (exact or
    wrapped) sum over the count.
    """
    aggregate = aggregate or ("count",)
    kind = aggregate[0]
    keys = np.stack([columns[q].astype(np.int64) for q in group_by], axis=1)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    g = uniq.shape[0]
    cnt = np.bincount(inv, minlength=g).astype(np.int32)
    out = {q: uniq[:, i].astype(np.int32) for i, q in enumerate(group_by)}
    name = agg_output_name(aggregate)
    if kind == "count":
        out[name] = cnt
        return out
    vals = evaluate(aggregate[1], lambda q: columns[q].astype(np.int64))
    sm = np.zeros(g, np.int64)
    np.add.at(sm, inv, vals)
    if wrap32:
        sm = sm.astype(np.int32)
    if kind == "sum":
        out[name] = sm
    elif kind == "avg":
        out[name] = sm.astype(np.float64) / np.maximum(cnt, 1)
    else:
        ext = np.full(g, 2**31 - 1 if kind == "min" else -(2**31), np.int64)
        (np.minimum if kind == "min" else np.maximum).at(ext, inv, vals)
        out[name] = ext.astype(np.int32)
    return out


def reference_execute(query: Query):
    """(sorted rows array, aggregate value) — the oracle for any join order.

    Grouped queries return the canonical group-row array with aggregate
    ``None`` (the aggregate is consumed per group, not a scalar).
    """
    cols = reference_rows(query)
    if query.group_by:
        return rows_array(apply_group_by(cols, query.group_by,
                                         query.aggregate,
                                         wrap32=query.wrap32)), None
    return rows_array(cols), apply_aggregate(cols, query.aggregate)


# ---------------------------------------------------------------------------
# Query generators (star / chain shapes for benchmarks, tests, workloads).
# ---------------------------------------------------------------------------

def make_star_query(fact_rows: int, dim_rows, *, selectivities=None,
                    seed: int = 0, aggregate: tuple | None = ("count",),
                    dim_tables=None, join_kinds=None,
                    group_by: tuple = ()) -> Query:
    """A star query: fact table F with one FK per dimension D0..Dk-1.

    Each dimension has a unique ``id`` key plus an ``a`` attribute in
    [0, 1000); ``selectivities[i]`` (None = no filter) adds a
    selectivity-annotated range filter on ``Di.a``.  ``dim_tables`` lets a
    caller (the workload generator's hot pool) supply recurring dimension
    tables so build-side caching pays across queries.  ``join_kinds[i]``
    (default inner) sets the variant of the i-th fact-dimension edge;
    ``group_by`` passes through to the Query (e.g. ``("F.g",)`` — the fact
    table always carries a low-cardinality ``g`` attribute to group on).
    """
    rng = np.random.default_rng(seed)
    dim_rows = list(dim_rows)
    selectivities = list(selectivities or [None] * len(dim_rows))
    join_kinds = list(join_kinds or ["inner"] * len(dim_rows))
    dims = list(dim_tables or [])
    for i in range(len(dims), len(dim_rows)):
        n = dim_rows[i]
        dims.append(Table(f"D{i}", {
            "id": rng.permutation(n).astype(np.int32),
            "a": rng.integers(0, 1000, size=n, dtype=np.int32)}))
    tables = {}
    fact_cols = {"m": rng.integers(0, 100, size=fact_rows, dtype=np.int32),
                 "g": rng.integers(0, 32, size=fact_rows, dtype=np.int32)}
    joins = []
    for i, d in enumerate(dims):
        sel = selectivities[i]
        if sel is not None:
            d = d.with_filters(Filter("a", 0, max(1, int(round(1000 * sel))),
                                      selectivity=sel))
        tables[d.name] = d
        fact_cols[f"fk{i}"] = rng.integers(0, dim_rows[i], size=fact_rows,
                                           dtype=np.int32)
        joins.append(Join("F", f"fk{i}", d.name, "id", kind=join_kinds[i]))
    tables["F"] = Table("F", fact_cols)
    return Query(tables=tables, joins=tuple(joins), aggregate=aggregate,
                 group_by=tuple(group_by))


def make_chain_query(sizes, *, seed: int = 0,
                     aggregate: tuple | None = ("count",)) -> Query:
    """A chain query T0 -> T1 -> ... : each table FK-references the next."""
    rng = np.random.default_rng(seed)
    sizes = list(sizes)
    tables = {}
    joins = []
    for i, n in enumerate(sizes):
        cols = {"id": rng.permutation(n).astype(np.int32),
                "v": rng.integers(0, 50, size=n, dtype=np.int32)}
        if i + 1 < len(sizes):
            cols["nxt"] = rng.integers(0, sizes[i + 1], size=n,
                                       dtype=np.int32)
            joins.append(Join(f"T{i}", "nxt", f"T{i+1}", "id"))
        tables[f"T{i}"] = Table(f"T{i}", cols)
    return Query(tables=tables, joins=tuple(joins), aggregate=aggregate)
