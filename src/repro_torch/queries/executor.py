"""Pipelined execution of a physical plan over the join-query engine.

Counterpart of ``repro/queries/executor.py`` over the port's
``JoinQueryService`` (C group on the host CPU, G group on the card).

Each ``PipelineStage`` becomes one ``JoinQuery`` submitted through
``JoinQueryService.submit_deferred``: a stage waits only on the stages
whose outputs it consumes, so independent subtrees of a bushy plan sit in
the admission queue together and overlap on the two device groups exactly
like unrelated queries do (C-only/G-only concurrency).

Stage hand-off is **device-resident** by default (``handoff="device"``):
a stage's output is a lazy ``StageView`` — the join result's probe/build
rid vectors, still on the card, plus back-pointers to the source views —
generalizing the fused-scan composition from base-table filters to *all*
intermediates.  A downstream stage's key (and, at the very end, payload)
gathers compose rid chains (``take(take(col, rid1), rid2)``) on the card
via ``core.relation.IndexChain``, so a 3-join star moves zero
intermediate column data through the host: only the exact-cardinality
match counts (and O(1) validation scalars) cross, because capacities must
be planned host-side.  The paper's core lesson applied between operators
— intermediates stop crossing the slow boundary.  ``handoff="host"`` keeps
the materialize path (every stage gathers its qualified columns to NumPy
and re-uploads the next stage's inputs) as a measurable baseline; either
path reports the bytes it moved through ``host_bytes_moved``.

Base tables are NumPy columns on the host.  The fused path uploads each
raw column it reads to the G group's device once per scan view, before
any gather: every chain gather, key column and stage relation then lies
on the card (``IndexChain.gather`` of a host column would gather on the
host).

Scan fusion: filtered base tables are NOT materialized before their first
join.  A ``_ScanView`` computes the filter's surviving row index once and
composes it directly into whatever gather consumes the table — the stage's
key column, or the stage output's payload gather — so a 2%-selective
dimension never copies its full column set through the mask.

Join variants ride the same pipeline: a semi/anti stage builds on its
filter table and emits only probe-side rows — the flag path is gather-free
and its rid vector composes directly into downstream chains; a left-outer
stage NULL-fills (``NULL_VALUE``) the build columns of unmatched rows,
carried as a device NULL mask that composes through later gathers.  A
``group_by`` query ends in one more engine submission — a ``GroupByQuery``
through the same admission queue — whose key/value inputs the fused path
hands over as device tensors (the sink consumes the view).

Reuse falls out of the engine untouched: a stage's build side is
fingerprinted like any other query, so a dimension table shared by many
queries hits the build-table cache (SHJ) or the partition-layout caches
(PHJ, both sides) after its first use.

Capacity planning: a stage's result buffer is sized from an exact match
count (a sort of the build keys and two ``searchsorted`` passes — on the
card for the fused path, host-side NumPy for the materialize path);
estimates drive *ordering*, but capacities must never truncate.  Deeper
stages get higher admission priority so in-flight pipelines drain before
fresh root stages are admitted.

Threads: ``submit_deferred`` runs each stage's ``make_query`` and
``finalize`` on a deferred-stage thread, outside the service's group
locks.  Their torch work on the card goes to the device's default stream,
which every thread shares, so it runs in enqueue order with the workers'
kernels; a stage's inputs are published (``inter``) before the handle its
dependents wait on resolves, so a consumer's launches are enqueued after
the producer's.  No further lock is needed for exact results; the cost is
that such work can land inside a running query's synchronized phase.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import time

import numpy as np
import torch

from ..core.relation import IndexChain, Relation, next_pow2, take_fill
from ..engine.service import GroupByQuery, JoinQuery, JoinQueryService
from ..obs import q_error

from .optimize import JoinOrderOptimizer, PhysicalPlan
from .plan import (NULL_VALUE, Query, agg_output_name, apply_aggregate,
                   rows_array)

# Filler keys for padding tiny/empty stage inputs up to a minimum size.
# Distinct negative values per side: they match neither real keys (>= 0)
# nor the engine's own pad sentinels (-2/-3) nor each other.
BUILD_FILL_KEY = -6
PROBE_FILL_KEY = -7
MIN_STAGE_ROWS = 64

HANDOFF_MODES = ("device", "host")


class _ScanView:
    """Lazy filtered scan of a base table (fused filter pushdown).

    Holds the raw host columns plus the surviving row index; columns are
    gathered on demand, and ``take`` composes the scan index with a
    consumer's row selection so the filtered table is never materialized
    as a whole intermediate.  ``raw_chain``/``col_dev`` are the
    device-resident face of the same idea: the raw column, uploaded once
    to ``device``, and the scan index as the root link of a downstream
    ``IndexChain``.
    """

    def __init__(self, table, device):
        self._name = table.name
        self._cols = table.columns          # raw, unfiltered (host)
        self._idx = table.scan_indices()    # None = no filters
        self.device = device
        self._memo: dict = {}
        self._raw_dev: dict = {}
        self._dev_memo: dict = {}
        self._chain: IndexChain | None = None
        self._fp_memo: dict = {}
        self._rows_tok: str | None = None

    @property
    def n(self) -> int:
        if self._idx is not None:
            return int(self._idx.shape[0])
        return next(iter(self._cols.values())).shape[0] if self._cols else 0

    def names(self):
        return [f"{self._name}.{c}" for c in self._cols]

    def _raw(self, q: str) -> np.ndarray:
        return self._cols[q.partition(".")[2]]

    def col(self, q: str) -> np.ndarray:
        """One filtered host column (memoized — typically the join key)."""
        if q not in self._memo:
            raw = self._raw(q)
            self._memo[q] = raw if self._idx is None else raw[self._idx]
        return self._memo[q]

    # -- device-resident protocol -------------------------------------------
    def raw_chain(self, q: str):
        """(raw column on the device, IndexChain into it, NULL mask).

        The raw column is uploaded once per view.  Base tables have no
        NULL mask; the chain is the scan index (or the identity when
        unfiltered).  The chain object is cached either way: downstream
        ``StageView._extend`` shares extensions per source-chain identity,
        so every column of this table must see the same object.
        """
        if self._chain is None:
            self._chain = (IndexChain() if self._idx is None else
                           IndexChain((torch.from_numpy(
                               self._idx.astype(np.int32)).to(self.device),)))
        raw = self._raw_dev.get(q)
        if raw is None:
            raw = self._raw_dev[q] = torch.from_numpy(
                np.ascontiguousarray(self._raw(q))).to(self.device)
        return raw, self._chain, None

    def col_dev(self, q: str) -> torch.Tensor:
        """One filtered column as a device tensor (memoized)."""
        if q not in self._dev_memo:
            raw, chain, _ = self.raw_chain(q)
            self._dev_memo[q] = chain.gather(raw)
        return self._dev_memo[q]

    def _rows_token(self) -> str:
        """Content token for the surviving-row selection."""
        if self._rows_tok is None:
            h = hashlib.sha1()
            if self._idx is None:
                h.update(b"all")
            else:
                h.update(np.asarray(self._idx).tobytes())
            h.update(f"|n={self.n}".encode())
            self._rows_tok = h.hexdigest()
        return self._rows_tok

    def col_fp(self, q: str) -> str:
        """Content fingerprint of one *filtered* column, computed entirely
        host-side (the raw columns live on the host): SHA-1 over the raw
        bytes plus the scan-index token, the bytes and order the JAX
        package hashes.  Equal content — even regenerated by a different
        ``Query`` object — hashes equal, which keeps the build-table cache
        hitting across repeated workloads without ever pulling a device
        column back to compute its key."""
        fp = self._fp_memo.get(q)
        if fp is None:
            h = hashlib.sha1()
            h.update(self._raw(q).tobytes())
            h.update(self._rows_token().encode())
            fp = self._fp_memo[q] = h.hexdigest()
        return fp

    def take(self, rows: np.ndarray) -> dict:
        """All host columns at the given (filtered-space) row positions.

        The scan index composes into the gather: one indexed read of each
        raw column instead of filter-materialize + gather.
        """
        if self._idx is not None:
            rows = self._idx[rows]
        return {f"{self._name}.{c}": v[rows] for c, v in self._cols.items()}

    def materialize(self) -> dict:
        return self.take(np.arange(self.n)) if self._idx is not None else \
            {f"{self._name}.{c}": v for c, v in self._cols.items()}

    def narrow(self, keep: np.ndarray) -> None:
        """Restrict to a boolean mask over current (filtered) rows —
        residual cycle-edge filters applied at scan time."""
        cur = (self._idx if self._idx is not None
               else np.arange(self.n))
        self._idx = cur[keep]
        self._memo.clear()
        self._dev_memo.clear()
        self._chain = None
        self._fp_memo.clear()
        self._rows_tok = None


def _match_stats(bkey: torch.Tensor, pkey: torch.Tensor,
                 kind: str) -> torch.Tensor:
    """Exact stage output cardinality, computed on the keys' device: a
    sort of the build keys and two ``searchsorted`` passes of the probe
    keys over them (the fused analogue of the host-side NumPy count).
    Only the build side is sorted.  Counts are int64."""
    bk = torch.sort(bkey.to(torch.int32)).values
    pk = pkey.to(torch.int32).contiguous()
    lo = torch.searchsorted(bk, pk, side="left")
    hi = torch.searchsorted(bk, pk, side="right")
    counts = hi - lo
    if kind == "semi":
        return (counts > 0).sum()
    if kind == "anti":
        return (counts == 0).sum()
    if kind == "left_outer":
        return torch.clamp(counts, min=1).sum()
    return counts.sum()


def _null_fill(col: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, NULL_VALUE, col)


class StageView:
    """Device-resident view of one join stage's output.

    Holds the engine's match-index vectors (``probe_rid``/``build_rid``,
    sliced to the valid count, on the card) plus back-pointers to the
    stage's input views.  Column access composes the source's index
    chain with the match vector — nothing is gathered until a key column
    is needed for the next stage, and payload columns are only gathered
    once, at final materialization, each via a single flattened-chain
    device gather.  Left-outer NULLs ride along as a device mask that
    composes through downstream gathers the same way.
    """

    def __init__(self, kind: str, psrc, bsrc, probe_rid, build_rid,
                 count: int, token: str | None = None):
        self.kind = kind
        self._psrc, self._bsrc = psrc, bsrc
        self._pr = probe_rid
        self._br = build_rid
        self.n = int(count)
        self._pset = set(psrc.names())
        self._rc_memo: dict = {}
        self._col_memo: dict = {}
        self._ext_memo: dict = {}
        # Structural execution token: SHA-1 over (stage kind, both input
        # column fingerprints, the *executed* QueryPlan's full knob set,
        # match count) — the engine is a deterministic function of those,
        # so equal tokens imply equal output content.  Downstream stages
        # derive their input fingerprints from it without a D2H pull;
        # ``None`` (no fingerprints available) falls back to the ledgered
        # content-hash path in the service.
        self._token = token

    def names(self):
        names = list(self._psrc.names())
        if self.kind not in ("semi", "anti"):
            names += self._bsrc.names()
        return names

    def _extend(self, chain: IndexChain, rid, tag: str) -> IndexChain:
        """Chain extension memoized per (source chain, side): columns of
        one table share the flattened index instead of re-folding it."""
        key = (id(chain), tag)
        ext = self._ext_memo.get(key)
        if ext is None:
            ext = chain.extend(rid)
            self._ext_memo[key] = (chain, ext)   # hold chain: id stability
        else:
            ext = ext[1]
        return ext

    def raw_chain(self, q: str):
        """(raw device column, IndexChain, NULL mask) — the composable
        form downstream stages extend (memoized per column)."""
        hit = self._rc_memo.get(q)
        if hit is not None:
            return hit
        if q in self._pset:
            raw, chain, mask = self._psrc.raw_chain(q)
            chain = self._extend(chain, self._pr, "p")
            if mask is not None:
                mask = take_fill(mask, self._pr)
            out = (raw, chain, mask)
        elif self.kind == "left_outer":
            if self._bsrc.n == 0:
                # Filtered-to-nothing build side: every row is NULL; the
                # chain gathers a 1-row zero stand-in nobody reads.
                dev = self._pr.device
                out = (torch.zeros(1, dtype=torch.int32, device=dev),
                       IndexChain((torch.zeros(self.n, dtype=torch.int32,
                                               device=dev),)),
                       torch.ones(self.n, dtype=torch.bool, device=dev))
            else:
                raw, chain, mask = self._bsrc.raw_chain(q)
                matched = self._br >= 0
                br = torch.clamp(self._br, min=0)
                chain = self._extend(chain, br, "b")
                null = ~matched
                if mask is not None:
                    null = null | take_fill(mask, br)
                out = (raw, chain, null)
        else:
            raw, chain, mask = self._bsrc.raw_chain(q)
            chain = self._extend(chain, self._br, "b")
            if mask is not None:
                mask = take_fill(mask, self._br)
            out = (raw, chain, mask)
        self._rc_memo[q] = out
        return out

    def col_dev(self, q: str) -> torch.Tensor:
        """One output column as a device tensor (memoized): a single
        flattened-chain gather, NULL-masked when an outer edge applies."""
        if q not in self._col_memo:
            raw, chain, mask = self.raw_chain(q)
            col = chain.gather(raw)
            if mask is not None:
                col = _null_fill(col, mask)
            self._col_memo[q] = col
        return self._col_memo[q]

    def col_fp(self, q: str) -> str | None:
        """Structural fingerprint of one output column: the execution
        token qualified by the column name.  No tensor bytes are read —
        soundness comes from the token construction (deterministic engine
        over fingerprinted inputs)."""
        if self._token is None:
            return None
        return f"{self._token}|col={q}"

    def materialize(self) -> dict:
        """Host columns — final result delivery only (one D2H per
        column; intermediates never take this path on the fused route)."""
        return {q: self.col_dev(q).cpu().numpy() for q in self.names()}

    def narrow(self, keep_idx: torch.Tensor) -> None:
        """Restrict to the given (device) row indices — residual
        cycle-edge filters applied to this stage's output."""
        self._pr = take_fill(self._pr, keep_idx)
        if self._br is not None:
            self._br = take_fill(self._br, keep_idx)
        self.n = int(keep_idx.shape[0])
        self._rc_memo.clear()
        self._col_memo.clear()
        self._ext_memo.clear()
        self._token = None      # content changed; caller re-derives

    def apply_residual(self, left_q: str, right_q: str) -> None:
        """Equality filter between two output columns, on the device: the
        surviving index comes from ``nonzero``, whose row count is the one
        scalar that crosses to the host (never the mask itself).  Links
        stay int32, as every chain link is."""
        mask = self.col_dev(left_q) == self.col_dev(right_q)
        keep = torch.nonzero(mask).squeeze(1).to(torch.int32)
        k = int(keep.shape[0])
        tok = self._token
        self.narrow(keep)
        if tok is not None:
            # The residual is a deterministic function of the pre-filter
            # content, so the token extends instead of dying.
            self._token = hashlib.sha1(
                f"{tok}|res:{left_q}={right_q}|k={k}".encode()).hexdigest()


def _src_n(src) -> int:
    if isinstance(src, (_ScanView, StageView)):
        return src.n
    return next(iter(src.values())).shape[0] if src else 0


def _src_names(src) -> list:
    if isinstance(src, (_ScanView, StageView)):
        return src.names()
    return list(src)


def _src_col(src, q: str) -> np.ndarray:
    return src.col(q) if isinstance(src, _ScanView) else src[q]


def _src_take(src, rows: np.ndarray) -> dict:
    if isinstance(src, _ScanView):
        return src.take(rows)
    return {q: v[rows] for q, v in src.items()}


def _as_relation(col: np.ndarray, fill_key: int, device) -> Relation:
    """A core Relation over a host column, rid = row index (gather
    convention) — the host-materialize path's H2D upload to ``device``.

    The fingerprint hint is a content hash computed from the *host* copy
    before the upload, so the engine's cache keying never pulls the
    column back down — content-equal inputs still share a cache line.
    """
    n = col.shape[0]
    if n and int(col.min()) < 0:
        raise ValueError(
            "negative join-key values are unsupported: they collide with "
            "the executor's fill keys and the engine's pad sentinels")
    col = np.asarray(col, dtype=np.int32)
    rid = np.arange(n, dtype=np.int32)
    if n < MIN_STAGE_ROWS:
        pad = MIN_STAGE_ROWS - n
        col = np.concatenate([col, np.full(pad, fill_key, np.int32)])
        rid = np.concatenate([rid, np.full(pad, -1, np.int32)])
    h = hashlib.sha1(col.tobytes())
    h.update(rid.tobytes())
    return Relation(torch.from_numpy(rid).to(device),
                    torch.from_numpy(np.ascontiguousarray(col)).to(device),
                    fp_hint=f"host:{h.hexdigest()}")


def _as_relation_dev(col: torch.Tensor, fill_key: int,
                     fp_hint: str | None = None) -> Relation:
    """Device twin of ``_as_relation``: the column never leaves the
    device (the caller has already validated keys non-negative).
    ``fp_hint`` is the source view's structural column fingerprint;
    the fill key and row count pin down the padding this function adds,
    making the hint content-complete for the padded relation."""
    n = int(col.shape[0])
    dev = col.device
    rid = torch.arange(n, dtype=torch.int32, device=dev)
    col = col.to(torch.int32)
    if n < MIN_STAGE_ROWS:
        pad = MIN_STAGE_ROWS - n
        col = torch.cat([col, torch.full((pad,), fill_key,
                                         dtype=torch.int32, device=dev)])
        rid = torch.cat([rid, torch.full((pad,), -1, dtype=torch.int32,
                                         device=dev)])
    hint = (f"{fp_hint}|fill={fill_key}|n={n}"
            if fp_hint is not None else None)
    return Relation(rid, col, fp_hint=hint)


def _check_keys_nonneg(*keys) -> None:
    """Negative-key validation for the fused path: only O(1) scalars
    (the mins) cross the host boundary."""
    for k in keys:
        if k.shape[0] and int(k.min()) < 0:
            raise ValueError(
                "negative join-key values are unsupported: they collide "
                "with the executor's fill keys and the engine's pad "
                "sentinels")


def _apply_residual(cols: dict, left_q: str, right_q: str) -> dict:
    """Cycle-edge equality filter over one component's host columns."""
    mask = cols[left_q] == cols[right_q]
    return {q: v[mask] for q, v in cols.items()}


def _match_count(build_keys: np.ndarray, probe_keys: np.ndarray,
                 kind: str = "inner") -> int:
    """Exact stage output cardinality (host-side searchsorted passes)."""
    bk = np.sort(build_keys.astype(np.int64), kind="stable")
    pk = probe_keys.astype(np.int64)
    counts = (np.searchsorted(bk, pk, side="right")
              - np.searchsorted(bk, pk, side="left"))
    if kind == "semi":
        return int((counts > 0).sum())
    if kind == "anti":
        return int((counts == 0).sum())
    if kind == "left_outer":
        return int(np.maximum(counts, 1).sum())
    return int(counts.sum())


def _mark_degraded(make_query):
    """Wrap a stage's query factory so the stage runs on the planner's
    cheapest plan — the whole-pipeline degrade admission promised."""
    def wrapped(dep_outcomes):
        q = make_query(dep_outcomes)
        q.degraded = True
        return q
    return wrapped


@dataclasses.dataclass
class PipelineResult:
    """Outcome of one pipelined query execution.

    ``columns`` materializes lazily: the fused path delivers the final
    intermediate as a device view, and a count-sink query never needs the
    payload gathered at all.  Accessing ``columns``/``rows_array`` pulls
    it to the host once (result delivery — not counted as intermediate
    traffic).
    """

    rows: int
    aggregate: object             # None | int | float
    outcomes: list                # QueryOutcome per stage (+ group-by sink)
    wall_s: float
    physical: PhysicalPlan
    _source: object = None        # dict | _ScanView | StageView
    _columns: dict | None = None
    _ledger: object = None        # TransferLedger for result attribution
    # Structured record of every adaptive mid-pipeline re-ordering this
    # execution performed (empty for static runs).
    replans: list = dataclasses.field(default_factory=list)

    @property
    def columns(self) -> dict:
        """Final qualified columns (NumPy), materialized on first use."""
        if self._columns is None:
            src = self._source
            self._columns = src if isinstance(src, dict) else \
                src.materialize()
            if self._ledger is not None and isinstance(src, StageView):
                self._ledger.record(
                    sum(v.nbytes for v in self._columns.values()),
                    cause="result", stage="result", column="*",
                    direction="d2h")
        return self._columns

    @property
    def host_bytes_moved(self) -> int:
        """Intermediate hand-off bytes across all stages (+ sink)."""
        return sum(o.host_bytes_moved for o in self.outcomes)

    def rows_array(self) -> np.ndarray:
        return rows_array(self.columns)

    def to_dict(self) -> dict:
        return {"rows": self.rows, "aggregate": self.aggregate,
                "wall_s": self.wall_s,
                "est_total_s": self.physical.est_total_s,
                "host_bytes_moved": self.host_bytes_moved,
                "replans": list(self.replans),
                "stages": [o.to_dict() for o in self.outcomes]}


class PipelineExecutor:
    """Runs physical plans through a (possibly shared) JoinQueryService.

    ``handoff`` selects the stage hand-off data path: ``"device"`` (the
    fused default — intermediates stay resident as ``StageView``s) or
    ``"host"`` (materialize every stage's qualified columns to NumPy; the
    pre-fusion baseline).

    ``adaptive=True`` turns on mid-pipeline re-optimization (fused path
    only): stages execute in dependency waves, every completed stage's
    exact device-observed cardinality is compared against the optimizer's
    estimate, and when the worst q-error in a wave crosses
    ``qerror_threshold`` the not-yet-admitted tail is re-priced from the
    observed numbers (``JoinOrderOptimizer.reprice_remaining``) and
    re-ordered if the challenger clears the planner's replan margin.
    Cardinality *recording* is always on — adaptivity only changes
    whether the pipeline acts on it.

    With no ``service`` it builds ``JoinQueryService(num_workers=2)``,
    whose ``CoProcessor`` puts the G group on the card; without one that
    raises.
    """

    def __init__(self, service: JoinQueryService | None = None,
                 optimizer: JoinOrderOptimizer | None = None,
                 handoff: str = "device", *, adaptive: bool = False,
                 qerror_threshold: float = 2.0):
        if handoff not in HANDOFF_MODES:
            raise ValueError(f"unknown handoff mode {handoff!r}")
        self.service = service or JoinQueryService(num_workers=2)
        self.optimizer = optimizer or JoinOrderOptimizer(
            self.service.planner, handoff=handoff)
        self.handoff = handoff
        self.adaptive = bool(adaptive)
        self.qerror_threshold = float(qerror_threshold)
        self._qid = itertools.count(1)

    @property
    def device(self) -> torch.device:
        """Where stage inputs and intermediates live: the G group's
        device."""
        return self.service.cp.g.device

    def close(self, drain: bool = True):
        self.service.close(drain=drain)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _degraded_total_s(self, physical: PhysicalPlan) -> float | None:
        """The pipeline's total estimate when every stage runs on the
        planner's cheapest plan — the degrade option admission weighs
        before shedding a whole pipeline."""
        try:
            total = 0.0
            for s in physical.stages:
                p = self.service.planner.choose_degraded(
                    max(s.est_build, 1), max(s.est_probe, 1),
                    max_out=self._stage_capacity(s.est_out),
                    cached=False, kind=s.kind, record=False)
                total += float(p.est_s)
            if physical.agg_plan is not None:
                total += float(physical.agg_plan.est_s)
            return total
        except Exception:
            return None

    # -- the pipeline --------------------------------------------------------
    def run(self, query: Query, physical: PhysicalPlan | None = None, *,
            tenant: str = "default",
            deadline_s: float | None = None) -> PipelineResult:
        """Execute ``query`` under ``physical`` (optimized when omitted).

        ``tenant``/``deadline_s`` bill the whole pipeline to one workload
        container: admission decides *once*, at the root, on the plan's
        total estimate (``est_total_s``) — the pipeline is admitted,
        degraded (every stage re-priced to the cheapest plan), or shed
        coherently with a structured ``Backpressure``, never half-run.
        Stages then carry the inherited tenant and absolute deadline
        through the queue pre-admitted.

        A pipeline failure lands in the service's flight recorder;
        stage-level failures were already recorded where they happened
        and are not re-recorded.
        """
        from ..engine.admission import QueueFull
        try:
            return self._run_pipeline(query, physical, tenant=tenant,
                                      deadline_s=deadline_s)
        except Exception as e:
            if (not isinstance(e, QueueFull)      # sheds are not failures
                    and not getattr(e, "_svc_failure_counted", False)):
                e._svc_failure_counted = True
                self.service.flight.record_failure(
                    tenant=tenant, where="pipeline", error=repr(e))
            raise

    def _run_pipeline(self, query: Query,
                      physical: PhysicalPlan | None = None, *,
                      tenant: str = "default",
                      deadline_s: float | None = None) -> PipelineResult:
        if physical is None:
            physical = self.optimizer.optimize(query)
        with self.service.tracer.span("pipeline", tenant=tenant,
                                      stages=len(physical.stages),
                                      handoff=self.handoff):
            deadline_at, degraded = self.service.admit_pipeline(
                tenant=tenant, est_s=physical.est_total_s,
                deadline_s=deadline_s, query_id=next(self._qid),
                degraded_est_s=self._degraded_total_s(physical))
            base = {name: _ScanView(t, self.device)
                    for name, t in query.tables.items()}
            # Residual (cycle-edge) filters on base tables apply at scan
            # time; the rest are grouped by the stage whose output they
            # filter.
            stage_residuals: dict[int, list] = {}
            for ref, lq, rq in physical.residuals:
                if isinstance(ref, str):
                    base[ref].narrow(base[ref].col(lq) == base[ref].col(rq))
                else:
                    stage_residuals.setdefault(ref, []).append((lq, rq))
            t0 = time.perf_counter()
            if not physical.stages:
                if len(base) != 1:
                    raise ValueError("plan has no stages but several tables")
                view = next(iter(base.values()))
                return self._finish(query, physical, view, [], t0,
                                    from_stages=False, tenant=tenant,
                                    deadline_at=deadline_at)

            inter: dict[int, object] = {}  # stage id -> cols | StageView
            depth: dict[int, int] = {}
            handles: dict[int, object] = {}
            handoff_bytes: dict[int, int] = {}  # host-path H2D per stage
            fused = self.handoff == "device"
            # Adaptive mid-pipeline re-optimization needs the frontier-wave
            # schedule (observe a wave, then admit the next); it applies on
            # the fused path to plans whose edges all became stages (cycle
            # edges carry residual state a re-order would have to re-home).
            if (self.adaptive and fused and not physical.residuals
                    and len(physical.stages) == len(physical.order)):
                physical, outcomes, final, replans = self._run_adaptive(
                    query, physical, base, inter, depth, degraded=degraded,
                    tenant=tenant, deadline_at=deadline_at)
                return self._finish(query, physical, final, outcomes, t0,
                                    tenant=tenant, deadline_at=deadline_at,
                                    degraded=degraded, replans=replans)
            for stage in physical.stages:
                depth[stage.stage_id] = 1 + max(
                    [depth[d] for d in stage.deps], default=0)
                make_query = (self._stage_query_dev(stage, base, inter)
                              if fused else
                              self._stage_query_host(stage, base, inter,
                                                     handoff_bytes))
                if degraded:
                    make_query = _mark_degraded(make_query)
                finalize = (self._stage_finalize_dev(
                    stage, base, inter,
                    stage_residuals.get(stage.stage_id, ()),
                    depth=depth[stage.stage_id])
                    if fused else
                    self._stage_finalize_host(
                        stage, base, inter,
                        stage_residuals.get(stage.stage_id, ()),
                        handoff_bytes, depth=depth[stage.stage_id]))
                handles[stage.stage_id] = self.service.submit_deferred(
                    make_query,
                    deps=[handles[d] for d in stage.deps],
                    finalize=finalize,
                    priority=depth[stage.stage_id],
                    tenant=tenant, deadline_at=deadline_at)
            outcomes = [handles[s.stage_id]() for s in physical.stages]
            final = inter[physical.stages[-1].stage_id]
            return self._finish(query, physical, final, outcomes, t0,
                                tenant=tenant, deadline_at=deadline_at,
                                degraded=degraded)

    def _run_adaptive(self, query, physical, base, inter, depth, *,
                      degraded, tenant, deadline_at):
        """Frontier-wave execution with observed-cardinality replans.

        Dependency-free stages of the remaining tail are admitted as one
        concurrent wave; when the wave completes, each stage's exact
        device-observed cardinality is recorded against its estimate, and
        a wave whose worst q-error crosses the threshold triggers a
        re-pricing of the not-yet-admitted tail.  A re-ordering that
        clears the replan margin splices into the plan before the next
        wave is admitted.
        """
        pending = list(physical.stages)
        executed_joins: list = []
        exec_ids: list = []
        observed: dict = {}
        outcomes_by_id: dict = {}
        replans: list = []
        next_id = itertools.count(
            max(s.stage_id for s in physical.stages) + 1)
        while pending:
            # Wave boundary = the pipeline's preemption point: a blown
            # deadline aborts here with the same structured error the
            # kernels' pass boundaries raise, before the next wave burns
            # device time on a guaranteed miss.
            if (getattr(self.service, "preempt", False)
                    and deadline_at is not None
                    and self.service._clock() > deadline_at):
                from ..engine.resilience import DeadlineExceeded
                raise DeadlineExceeded(
                    f"pipeline deadline passed with {len(pending)} "
                    f"stage(s) unexecuted", reason="deadline_exceeded",
                    tenant=tenant, deadline_s=0.0)
            wave = [s for s in pending if all(d in inter for d in s.deps)]
            handles = {}
            for stage in wave:
                depth[stage.stage_id] = 1 + max(
                    [depth[d] for d in stage.deps], default=0)
                make_query = self._stage_query_dev(stage, base, inter)
                if degraded:
                    make_query = _mark_degraded(make_query)
                handles[stage.stage_id] = self.service.submit_deferred(
                    make_query, deps=[],       # wave inputs are all ready
                    finalize=self._stage_finalize_dev(
                        stage, base, inter, (),
                        depth=depth[stage.stage_id]),
                    priority=depth[stage.stage_id],
                    tenant=tenant, deadline_at=deadline_at)
            worst_q = 1.0
            for stage in wave:
                outcomes_by_id[stage.stage_id] = handles[stage.stage_id]()
                executed_joins.append(stage.join)
                exec_ids.append(stage.stage_id)
                n_obs = inter[stage.stage_id].n
                observed[id(stage.join)] = n_obs
                worst_q = max(worst_q, q_error(stage.est_out, n_obs))
            pending = [s for s in pending if s.stage_id not in handles]
            if not pending or worst_q < self.qerror_threshold:
                continue
            replanned = self.optimizer.reprice_remaining(
                query, executed_joins, [s.join for s in pending], observed)
            if replanned is None:
                continue
            old_tail = [str(s.join) for s in pending]
            physical, pending = self._splice_replan(
                physical, replanned, exec_ids, next_id)
            rec = {"after_stages": len(exec_ids),
                   "worst_q_error": round(float(worst_q), 3),
                   "old_tail": old_tail,
                   "new_tail": [str(s.join) for s in pending],
                   "est_total_s": float(replanned.est_total_s)}
            replans.append(rec)
            self.service.metrics.inc("pipeline_replans")
            self.service.metrics.event("replan", tenant=tenant, **rec)
            self.service.tracer.instant(
                "replan", tenant=tenant,
                after_stages=rec["after_stages"],
                worst_q_error=rec["worst_q_error"])
        outcomes = [outcomes_by_id[s.stage_id] for s in physical.stages]
        final = inter[physical.stages[-1].stage_id]
        return physical, outcomes, final, replans

    def _splice_replan(self, physical, replanned, exec_ids, next_id):
        """Graft a re-priced plan onto the executed prefix.

        ``replanned`` re-states the executed joins as its first stages
        (same joins, same order — ``reprice_remaining`` permutes only the
        tail); those keep their original stage ids so the ``inter`` and
        outcome bookkeeping stands.  Tail stages get fresh never-reused
        ids, with input/dep references remapped.
        """
        n_exec = len(exec_ids)
        id_map = {s.stage_id: exec_ids[i]
                  for i, s in enumerate(replanned.stages[:n_exec])}
        new_tail = []
        for s in replanned.stages[n_exec:]:
            id_map[s.stage_id] = next(next_id)
            new_tail.append(dataclasses.replace(
                s, stage_id=id_map[s.stage_id],
                build_input=(id_map[s.build_input]
                             if isinstance(s.build_input, int)
                             else s.build_input),
                probe_input=(id_map[s.probe_input]
                             if isinstance(s.probe_input, int)
                             else s.probe_input),
                deps=tuple(sorted(id_map[d] for d in s.deps))))
        by_id = {st.stage_id: st for st in physical.stages}
        exec_stages = [by_id[sid] for sid in exec_ids]
        new_physical = dataclasses.replace(
            replanned, stages=exec_stages + new_tail,
            order=tuple(s.join for s in exec_stages + new_tail))
        return new_physical, new_tail

    def _finish(self, query, physical, cols, outcomes, t0, *,
                from_stages: bool = True, tenant: str = "default",
                deadline_at: float | None = None,
                degraded: bool = False,
                replans: list | None = None) -> PipelineResult:
        """Apply the sink (group-by through the engine, or a host scalar).

        The wall clock stops after the groups' ``synchronize``: a
        count-only sink reads its count on the host and launches nothing
        that would wait for the card."""
        if query.group_by:
            cols, sink_outcome = self._run_group_by(
                query, cols, count_handoff=from_stages, tenant=tenant,
                deadline_at=deadline_at, degraded=degraded)
            outcomes = outcomes + [sink_outcome]
            agg = None
            rows = next(iter(cols.values())).shape[0] if cols else 0
            source = cols
        else:
            agg = self._apply_scalar_sink(query, cols)
            rows = _src_n(cols) if not isinstance(cols, dict) else (
                next(iter(cols.values())).shape[0] if cols else 0)
            source = cols
        self.service.cp.synchronize()
        wall = time.perf_counter() - t0
        return PipelineResult(
            rows=rows, aggregate=agg, outcomes=outcomes, wall_s=wall,
            physical=physical, _source=source,
            _ledger=self.service.ledger, replans=replans or [])

    def _apply_scalar_sink(self, query: Query, cols):
        """Scalar aggregate without forcing full materialization: count
        needs only the (host-side) cardinality, sum/min/max/avg gather
        exactly one column from a device view."""
        if query.aggregate is None:
            return None
        if isinstance(cols, dict):
            return apply_aggregate(cols, query.aggregate)
        kind = query.aggregate[0]
        if kind == "count":
            return cols.n
        q = query.aggregate[1]
        if isinstance(cols, StageView):
            arr = cols.col_dev(q).cpu().numpy()
            self.service.note_host_bytes(
                arr.nbytes, cause="result", stage="sink", column=q,
                direction="d2h")
            return apply_aggregate({q: arr}, query.aggregate)
        return apply_aggregate({q: cols.col(q)}, query.aggregate)

    # -- group-by sink -------------------------------------------------------
    def _run_group_by(self, query: Query, cols, *,
                      count_handoff: bool = True, tenant: str = "default",
                      deadline_at: float | None = None,
                      degraded: bool = False):
        """One ``GroupByQuery`` through the service's admission queue.

        A device view hands the sink its key/value columns as device
        tensors (zero intermediate host bytes for single-column keys);
        multi-column keys still pack their dictionary host-side, which is
        counted as hand-off traffic.
        """
        aggregate = query.aggregate or ("count",)
        moved = 0
        is_view = isinstance(cols, (StageView, _ScanView))
        if is_view and len(query.group_by) == 1:
            q = query.group_by[0]
            keys = cols.col_dev(q).to(torch.int32)
            dev = keys.device
            decode = (lambda k: {q: k.astype(np.int32)})
            n = cols.n
            if aggregate[0] == "count":
                values = torch.ones(n, dtype=torch.int32, device=dev)
            else:
                values = cols.col_dev(aggregate[1]).to(torch.int32)
            rid = torch.arange(n, dtype=torch.int32, device=dev)
            if n < MIN_STAGE_ROWS:
                pad = MIN_STAGE_ROWS - n
                keys = torch.cat([keys, torch.full(
                    (pad,), -4, dtype=torch.int32, device=dev)])
                rid = torch.cat([rid, torch.full(
                    (pad,), -1, dtype=torch.int32, device=dev)])
            rel = Relation(rid, keys)
        else:
            if is_view:
                # Multi-column keys: host dictionary packing needs the key
                # columns (plus the value column) on host — counted.
                need = set(query.group_by)
                if aggregate[0] != "count":
                    need.add(aggregate[1])
                host_cols = {q: cols.col_dev(q).cpu().numpy()
                             if isinstance(cols, StageView)
                             else cols.col(q) for q in need}
                if isinstance(cols, StageView) and count_handoff:
                    pulled = sum(v.nbytes for v in host_cols.values())
                    moved += pulled
                    self.service.note_host_bytes(
                        pulled, cause="multicol_pack",
                        stage="groupby-sink", column="+".join(sorted(need)),
                        direction="d2h")
                cols = host_cols
            keys, decode = self._encode_group_keys(cols, query.group_by)
            n = keys.shape[0]
            if aggregate[0] == "count":
                values = np.ones(n, np.int32)
            else:
                values = np.asarray(cols[aggregate[1]], dtype=np.int32)
            rid = np.arange(n, dtype=np.int32)
            if n < MIN_STAGE_ROWS:                  # empty/tiny pipelines
                pad = MIN_STAGE_ROWS - n
                keys = np.concatenate([keys,
                                       np.full(pad, -4, np.int32)])
                rid = np.concatenate([rid, np.full(pad, -1, np.int32)])
            if count_handoff:
                # Host hand-off into the sink: keys + rid + values H2D.
                # Packed multi-column keys sourced from a device view are
                # packing traffic (``multicol_pack``), not a hand-off —
                # the fused path's ``handoff`` cause stays zero.
                upload = keys.nbytes + rid.nbytes + values.nbytes
                moved += upload
                self.service.note_host_bytes(
                    upload,
                    cause="multicol_pack" if is_view else "handoff",
                    stage="groupby-sink", column="keys+rid+values",
                    direction="h2d")
            rel = Relation(
                torch.from_numpy(rid).to(self.device),
                torch.from_numpy(np.ascontiguousarray(
                    keys, dtype=np.int32)).to(self.device))
        gq = GroupByQuery(keys=rel, values=values, tag="groupby-sink",
                          query_id=next(self._qid), wrap32=query.wrap32,
                          tenant=tenant, deadline_at=deadline_at,
                          degraded=degraded)
        if self.service.num_workers <= 0:
            outcome = self.service.execute(gq)
        else:
            # Pre-admitted: the pipeline-root decision already covered the
            # sink; re-deciding here could shed it after its stages ran.
            outcome = self.service.submit(gq, preadmitted=True)()
        outcome.host_bytes_moved += moved
        res = outcome.result
        out = decode(res.keys)
        name = agg_output_name(aggregate)
        kind = aggregate[0]
        if kind == "count":
            out[name] = res.counts.astype(np.int32)
        elif kind == "sum":
            out[name] = res.sums.astype(np.int32 if query.wrap32
                                        else np.int64)
        elif kind == "min":
            out[name] = res.mins.astype(np.int32)
        elif kind == "max":
            out[name] = res.maxs.astype(np.int32)
        else:                                   # avg: sum / count, float64
            out[name] = res.sums.astype(np.float64) / \
                np.maximum(res.counts, 1)
        return out, outcome

    def _encode_group_keys(self, cols: dict, group_by: tuple):
        """int32 key vector + a decoder back to the original key columns.

        A single group-by column passes through raw (any int32 values —
        the operator's pad handling tolerates negatives, including outer-
        join NULLs).  Multiple columns mixed-radix pack their per-column
        dictionary codes; the group-by itself still runs on the device,
        the host only builds the per-column dictionaries.
        """
        if len(group_by) == 1:
            q = group_by[0]
            return np.asarray(cols[q], dtype=np.int32), \
                lambda k: {q: k.astype(np.int32)}
        dicts, codes, radix = [], [], 1
        for q in group_by:
            uniq, inv = np.unique(np.asarray(cols[q]), return_inverse=True)
            dicts.append(uniq)
            codes.append(inv.astype(np.int64))
        packed = np.zeros(codes[0].shape[0] if codes else 0, np.int64)
        for uniq, inv in zip(dicts, codes):
            packed = packed * max(1, uniq.shape[0]) + inv
            radix *= max(1, uniq.shape[0])
        if radix >= 2**31:
            raise ValueError(
                f"group_by key space too large to pack into int32 "
                f"({radix} combinations)")

        def decode(k: np.ndarray) -> dict:
            k = k.astype(np.int64)
            out = {}
            for q, uniq in zip(reversed(group_by), reversed(dicts)):
                r = max(1, uniq.shape[0])
                out[q] = uniq[(k % r)].astype(np.int32) if uniq.size else \
                    np.zeros(k.shape[0], np.int32)
                k = k // r
            return out

        return packed.astype(np.int32), decode

    # -- per-stage plumbing --------------------------------------------------
    def _input(self, ref, base, inter):
        return base[ref] if isinstance(ref, str) else inter[ref]

    def _stage_capacity(self, matches: int) -> int:
        # Power-of-two capacity: stable across repeats of the same
        # pipeline (plan- and cache-friendly) with headroom for the
        # executor's per-group split slack.
        return next_pow2(max(4 * MIN_STAGE_ROWS,
                             matches + matches // 4 + 256))

    # -- fused (device-resident) hand-off ------------------------------------
    def _stage_query_dev(self, stage, base, inter):
        def make_query(_dep_outcomes) -> JoinQuery:
            bsrc = self._input(stage.build_input, base, inter)
            psrc = self._input(stage.probe_input, base, inter)
            bkey = bsrc.col_dev(stage.build_col)
            pkey = psrc.col_dev(stage.probe_col)
            _check_keys_nonneg(bkey, pkey)
            matches = int(_match_stats(bkey, pkey, stage.kind))
            return JoinQuery(
                build=_as_relation_dev(
                    bkey, BUILD_FILL_KEY,
                    fp_hint=bsrc.col_fp(stage.build_col)),
                probe=_as_relation_dev(
                    pkey, PROBE_FILL_KEY,
                    fp_hint=psrc.col_fp(stage.probe_col)),
                tag=f"stage{stage.stage_id}:{stage.join}",
                max_out=self._stage_capacity(matches),
                query_id=next(self._qid), kind=stage.kind)
        return make_query

    def _stage_finalize_dev(self, stage, base, inter, residuals=(), *,
                            depth: int = 0):
        def finalize(outcome) -> None:
            # Runs on the deferred-stage thread: the gather/finalize leg
            # of the lifecycle, spanned per stage (the executed query's
            # own spans closed on a worker thread already).
            with self.service.tracer.span(
                    "finalize", stage=stage.stage_id,
                    query_id=outcome.query_id, tenant=outcome.tenant,
                    tag=outcome.tag):
                with self.service.tracer.span("gather",
                                              stage=stage.stage_id):
                    bsrc = self._input(stage.build_input, base, inter)
                    psrc = self._input(stage.probe_input, base, inter)
                    c = int(outcome.result.count)
                    token = self._stage_token(stage, bsrc, psrc,
                                              outcome.plan, c)
                    # A stage the planner ran on the C group leaves its
                    # rid vectors on the host; they join the chains on
                    # the G group's device, as ``CoProcessor._collect``
                    # brings group pieces together there.
                    dev = self.device
                    view = StageView(
                        stage.kind, psrc, bsrc,
                        outcome.result.probe_rid[:c].to(dev),
                        None if stage.kind in ("semi", "anti")
                        else outcome.result.build_rid[:c].to(dev), c,
                        token=token)
                    for lq, rq in residuals:
                        view.apply_residual(lq, rq)
                    if residuals:
                        # The span ends after the residuals' device work.
                        self.service.cp.g.synchronize()
                inter[stage.stage_id] = view
                outcome.host_bytes_moved = 0  # the fused path's invariant
                self.service.cardinality.record(
                    stage_type=stage.kind, est_rows=stage.est_out,
                    observed_rows=c, depth=depth, tenant=outcome.tenant,
                    stage_id=stage.stage_id)
        return finalize

    @staticmethod
    def _stage_token(stage, bsrc, psrc, plan, count: int) -> str | None:
        """Execution token for a stage output: SHA-1 over the stage kind,
        both input column fingerprints, the *executed* plan's full knob
        set (estimate floats and the content-neutral ``cached`` bit
        excluded — they vary with calibration, not content), and the
        match count.  The engine is deterministic given those, so equal
        tokens imply byte-equal output; ``None`` when either input lacks
        a fingerprint, which sends downstream keying to the ledgered
        content-hash fallback."""
        bfp = bsrc.col_fp(stage.build_col)
        pfp = psrc.col_fp(stage.probe_col)
        if bfp is None or pfp is None:
            return None
        parts = (stage.kind, f"b:{bfp}", f"p:{pfp}", plan.algorithm,
                 plan.scheme, str(plan.build_ratios), str(plan.probe_ratios),
                 str(plan.num_buckets), str(plan.max_out),
                 str(plan.schedule), str(plan.shj_bits),
                 str(plan.partition_ratio), str(plan.join_ratio),
                 f"c={count}")
        return hashlib.sha1("|".join(parts).encode()).hexdigest()

    # -- host-materialize hand-off (the pre-fusion baseline) -----------------
    def _stage_query_host(self, stage, base, inter, handoff_bytes):
        def make_query(_dep_outcomes) -> JoinQuery:
            bsrc = self._input(stage.build_input, base, inter)
            psrc = self._input(stage.probe_input, base, inter)
            bkey = _src_col(bsrc, stage.build_col)
            pkey = _src_col(psrc, stage.probe_col)
            matches = _match_count(bkey, pkey, stage.kind)
            # H2D re-upload of intermediate-derived inputs: rid + key per
            # side whose source is a host-materialized stage output.
            moved = sum(
                2 * 4 * max(k.shape[0], MIN_STAGE_ROWS)
                for src, k in ((bsrc, bkey), (psrc, pkey))
                if isinstance(src, dict))
            if moved:
                handoff_bytes[stage.stage_id] = \
                    handoff_bytes.get(stage.stage_id, 0) + moved
                self.service.note_host_bytes(
                    moved, cause="handoff",
                    stage=f"stage{stage.stage_id}", column="rid+key",
                    direction="h2d")
            return JoinQuery(
                build=_as_relation(bkey, BUILD_FILL_KEY, self.device),
                probe=_as_relation(pkey, PROBE_FILL_KEY, self.device),
                tag=f"stage{stage.stage_id}:{stage.join}",
                max_out=self._stage_capacity(matches),
                query_id=next(self._qid), kind=stage.kind)
        return make_query

    def _stage_finalize_host(self, stage, base, inter, residuals=(),
                             handoff_bytes=None, *, depth: int = 0):
        def finalize(outcome) -> None:
            with self.service.tracer.span(
                    "finalize", stage=stage.stage_id,
                    query_id=outcome.query_id, tenant=outcome.tenant,
                    tag=outcome.tag):
                with self.service.tracer.span("gather",
                                              stage=stage.stage_id):
                    bsrc = self._input(stage.build_input, base, inter)
                    psrc = self._input(stage.probe_input, base, inter)
                    c = int(outcome.result.count)
                    pr = outcome.result.probe_rid[:c].cpu().numpy()
                    moved = pr.nbytes              # D2H: match indices
                    cols = _src_take(psrc, pr)
                    if stage.kind in ("semi", "anti"):
                        pass  # filter table consumed: probe columns only
                    elif stage.kind == "left_outer":
                        br = outcome.result.build_rid[:c].cpu().numpy()
                        moved += br.nbytes
                        # Unmatched rows carry NULL_VALUE on the build
                        # side.  An empty build side (filtered to nothing)
                        # has no rows to gather at all — everything is
                        # NULL.
                        matched = br >= 0
                        if _src_n(bsrc) == 0:
                            for q in _src_names(bsrc):
                                cols[q] = np.full(c, NULL_VALUE, np.int32)
                        else:
                            bcols = _src_take(bsrc,
                                              np.where(matched, br, 0))
                            for q, v in bcols.items():
                                cols[q] = np.where(matched, v,
                                                   v.dtype.type(NULL_VALUE))
                    else:
                        br = outcome.result.build_rid[:c].cpu().numpy()
                        moved += br.nbytes
                        cols.update(_src_take(bsrc, br))
                for lq, rq in residuals:
                    cols = _apply_residual(cols, lq, rq)
                inter[stage.stage_id] = cols
                self.service.note_host_bytes(
                    moved, cause="handoff",
                    stage=f"stage{stage.stage_id}", column="match_rids",
                    direction="d2h")
                outcome.host_bytes_moved = moved + \
                    (handoff_bytes or {}).get(stage.stage_id, 0)
                self.service.cardinality.record(
                    stage_type=stage.kind, est_rows=stage.est_out,
                    observed_rows=c, depth=depth, tenant=outcome.tenant,
                    stage_id=stage.stage_id)
        return finalize

    # -- convenience ---------------------------------------------------------
    def run_optimized(self, query: Query):
        """(chosen physical plan, result) in one call."""
        physical = self.optimizer.optimize(query)
        return physical, self.run(query, physical)
