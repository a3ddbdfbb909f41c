"""Semi / anti / left-outer joins over the existing probe series.

Counterpart of ``repro/ops/join_variants.py``.  The probe steps p1-p3
compute, per probe tuple, its matching key entry and match count; the
variants differ only in what p4 emits:

  * ``semi``: probe rows with >= 1 match, emitted once each (a flag
    compaction, no payload gather).
  * ``anti``: probe rows with 0 matches (pad rows excluded).
  * ``left_outer``: the inner expansion plus the unmatched rows, each once
    with ``build_rid == NULL_RID`` (-1, the padded-result sentinel doubling
    as SQL NULL).

All three run under the same C/G ratio splits as the inner probe, through
``CoProcessor.probe_table``, against the same (possibly cached) table.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import hash_table as ht
from ..core.coprocess import CoProcessor, Timing
from ..core.relation import Relation
from ..kernels.csr_probe import csr_lookup

JOIN_KINDS = ("inner", "semi", "anti", "left_outer")
NULL_RID = ht.INVALID   # -1: build side of an unmatched outer row


def _empty(max_out: int, dev) -> ht.JoinResult:
    pad = torch.full((max_out,), ht.INVALID, dtype=torch.int32, device=dev)
    return ht.JoinResult(pad, pad.clone(),
                         torch.zeros((), dtype=torch.int32, device=dev))


def _emit_flagged(probe_rid: torch.Tensor, flags: torch.Tensor,
                  max_out: int) -> ht.JoinResult:
    """Compact flagged probe rows to the front (semi/anti emission)."""
    n = probe_rid.shape[0]
    dev = probe_rid.device
    if n == 0:
        return _empty(max_out, dev)
    count = torch.clamp(flags.sum(dtype=torch.int32), max=max_out)
    rank = torch.arange(max_out, dtype=torch.int32, device=dev)
    # Flagged rows first, each side in row order: a stable sort of ~flags.
    order = torch.sort((~flags).to(torch.int8), stable=True).indices
    src = order[rank.clamp(0, n - 1)]
    out_probe = torch.where(rank < count, probe_rid[src], ht.INVALID)
    return ht.JoinResult(out_probe.to(torch.int32),
                         torch.full((max_out,), ht.INVALID,
                                    dtype=torch.int32, device=dev),
                         count.to(torch.int32))


def _probe_p4_outer(table: ht.HashTable, probe_rid: torch.Tensor,
                    entry: torch.Tensor, nmatch: torch.Tensor,
                    valid_row: torch.Tensor,
                    max_out: int) -> ht.JoinResult:
    """p4 with unmatched-row emission: fanout ``max(nmatch, 1)`` per row."""
    n = probe_rid.shape[0]
    dev = probe_rid.device
    if n == 0:
        return _empty(max_out, dev)
    nm_eff = torch.where(valid_row, torch.clamp(nmatch, min=1), 0) \
        .to(torch.int32)
    offs = torch.cumsum(nm_eff, 0, dtype=torch.int32)
    starts = offs - nm_eff
    out_idx = torch.arange(max_out, dtype=torch.int32, device=dev)
    src = torch.searchsorted(offs, out_idx, right=True)
    count = torch.clamp(offs[-1], max=max_out)
    valid = out_idx < count
    src_c = src.clamp(0, n - 1)
    j = out_idx - starts[src_c]
    cap = table.rids.shape[0]
    bpos = (table.key_rid_start[entry[src_c].clamp(0, cap - 1)] + j) \
        .clamp(0, cap - 1)
    matched = nmatch[src_c] > 0
    out_build = torch.where(valid & matched, table.rids[bpos], ht.INVALID)
    out_probe = torch.where(valid, probe_rid[src_c], ht.INVALID)
    return ht.JoinResult(out_probe.to(torch.int32),
                         out_build.to(torch.int32), count.to(torch.int32))


def probe_hash_table_variant(rel: Relation, table: ht.HashTable,
                             max_out: int, kind: str) -> ht.JoinResult:
    """Full probe phase under variant semantics (p1 -> p2 -> p3 -> emit),
    p2 + p3 as ``csr_lookup`` (its kernel on a CUDA device).

    Pad tuples (``rid == INVALID``) are never emitted; in particular they
    do not count as "unmatched" for anti/left_outer.
    """
    if kind not in JOIN_KINDS:
        raise ValueError(f"kind must be one of {JOIN_KINDS}: {kind!r}")
    if kind == "inner":
        return ht.probe_hash_table(rel, table, max_out)
    bkt = ht.probe_p1(rel.key, table.num_buckets)
    entry, nmatch = csr_lookup(table, bkt, rel.key)
    valid_row = rel.rid != ht.INVALID
    if kind == "semi":
        return _emit_flagged(rel.rid, (nmatch > 0) & valid_row, max_out)
    if kind == "anti":
        return _emit_flagged(rel.rid, (nmatch == 0) & valid_row, max_out)
    return _probe_p4_outer(table, rel.rid, entry, nmatch, valid_row,
                           max_out)


def probe_table_variant(cp: CoProcessor, probe_rel: Relation,
                        table: ht.HashTable, *, kind: str, max_out: int,
                        ratios, timing: Timing | None = None
                        ) -> tuple[ht.JoinResult, Timing]:
    """Variant probe against an existing (possibly cached) table.

    Delegates to ``CoProcessor.probe_table``: the same ratio cut, table
    copies, per-group capacity slack and concatenation, with the variant
    emission swapped in per group.
    """
    if kind == "inner":
        return cp.probe_table(probe_rel, table, max_out=max_out,
                              ratios=ratios, timing=timing)
    if kind not in JOIN_KINDS:
        raise ValueError(f"kind must be one of {JOIN_KINDS}: {kind!r}")

    def fn(mo):
        return lambda r, t: probe_hash_table_variant(r, t, mo, kind)

    return cp.probe_table(probe_rel, table, max_out=max_out, ratios=ratios,
                          timing=timing, probe_fn=fn, tag=f"probe_v:{kind}")


# ---------------------------------------------------------------------------
# NumPy oracle (testing/verification only).
# ---------------------------------------------------------------------------

def join_variant_oracle(build: Relation, probe: Relation,
                        kind: str) -> np.ndarray:
    """Sorted (probe_rid, build_rid) pairs under variant semantics."""
    inner = ht.join_oracle(build, probe)
    if kind == "inner":
        return inner
    pr = probe.rid.cpu().numpy()
    matched = np.unique(inner[:, 0])
    if kind == "semi":
        out = np.stack([matched, np.full(matched.size, NULL_RID)], axis=1)
        return out.astype(np.int64)
    unmatched = np.setdiff1d(pr, matched)
    miss = np.stack([unmatched, np.full(unmatched.size, NULL_RID)], axis=1)
    if kind == "anti":
        return miss.astype(np.int64)
    return ht.sort_pairs(np.concatenate([inner, miss.astype(np.int64)]))
