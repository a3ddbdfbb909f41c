"""Co-processed hash group-by aggregation (the join's sibling operator).

Counterpart of ``repro/ops/groupby.py``.  Group-by shares the join's
partition/probe cost structure: cluster the group keys with the same
radix passes PHJ uses (kernels A and B on CUDA), then reduce each
partition's tuples.  The co-processing skeleton mirrors
``CoProcessor.phj`` one-to-one:

  * **partition phase** — the key relation is ratio-split between the C
    and G groups (``partition_ratio``), each side runs the pass schedule;
  * **aggregate phase** — partitions are ownership-split (``agg_ratio``:
    C owns partition ids ``[0, own)``, selected with kernel D's ids on the
    device that holds the partitioned relation); each group sorts its
    owned tuples by key, derives dense group slots from boundary flags and
    reduces count/sum/min/max in one pass (kernel C on CUDA).  Identical
    keys land in one partition, so the two groups' group lists are
    disjoint and concatenate without a merge.

``schedule=None`` skips partitioning (the sort *is* the hash table).
``agg_ratio`` 0 or 1 then runs the whole relation on one group (the
CPU_ONLY / GPU_ONLY schemes); a fractional ratio row-splits it, each
group builds a partial group list on its share and the partials merge on
the host (the paper's separate-tables-plus-merge mode, Fig. 3).

Sums are exact int64 by default, carried through the device path as the
kernel's wide int32 channels and decoded on the device; ``wrap32=True``
keeps the legacy wrapping int32 accumulator.  The values are int32, or
int64 (a query's expression, widened so it is exact): an int64 value
``v`` goes through the kernel as two int32 words, ``v >> 32`` and the low
word less 2^31, whose exact sums recombine as ``2^32 hi + lo + 2^31
count``; min and max are then not taken (they read the neutral values).
The C group is the host CPU, so both ratios are required: a call never
lands on the CPU unless it says so.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.coprocess import CoProcessor, Timing, owned_slice
from ..core.hash_table import INVALID
from ..core.partition import radix_partition_scheduled
from ..core.relation import Relation, radix_of
from ..kernels.agg.agg import INT32_MAX, INT32_MIN, wide_sums_to_int64_tensor
from ..kernels.agg.ops import segmented_aggregate

# Pad sentinel for group-key relations: never collides with the join-side
# sentinels (-2/-3); pads carry rid == INVALID, which is what actually
# excludes them from aggregation.
GROUP_PAD_KEY = -4


@dataclasses.dataclass
class GroupByResult:
    """Host-side group list: one row per distinct key."""

    keys: np.ndarray       # (g,) int32 distinct group keys
    counts: np.ndarray     # (g,) int32 tuples per group
    sums: np.ndarray       # (g,) int64 exact sums (int32 wrap under wrap32)
    mins: np.ndarray       # (g,) int32
    maxs: np.ndarray       # (g,) int32

    @property
    def num_groups(self) -> int:
        return int(self.keys.shape[0])

    def sorted(self) -> "GroupByResult":
        """Key-ascending copy (canonical order for comparisons)."""
        o = np.argsort(self.keys, kind="stable")
        return GroupByResult(self.keys[o], self.counts[o], self.sums[o],
                             self.mins[o], self.maxs[o])

    def avgs(self) -> np.ndarray:
        """float64 means from the sums (exact by default, wrapped under
        ``wrap32``) — matches the oracle's mode."""
        return self.sums.astype(np.float64) / np.maximum(self.counts, 1)


def grouped_agg(rel: Relation, values: torch.Tensor, *, num_slots: int,
                wrap32: bool = False):
    """One group's aggregation: sort by key, flag boundaries, reduce.

    ``values[i]`` belongs to tuple ``i`` of ``rel``; pad tuples are marked
    by ``rid == INVALID`` and contribute nothing.  Returns padded
    ``(ukeys, count, sum, min, max, num_groups)`` — slot ``g`` holds the
    ``g``-th distinct key in uint32 order; slots past ``num_groups``
    report count 0.  ``sum`` is the kernel's wide-channel layout by
    default or a wrapping int32 vector under ``wrap32=True``; int64
    ``values`` give an exact int64 ``sum`` vector (two kernel calls, one
    a word) and neutral ``min`` / ``max``.
    """
    n, dev = rel.size, rel.device
    # uint32 order: flipping the sign bit maps it onto int32 order, so a
    # 4-byte stable sort gives the JAX package's order (pads, key -4,
    # after every non-negative key).
    order = torch.sort(rel.key ^ INT32_MIN, stable=True).indices
    skey = rel.key[order]
    svals = values[order]
    valid = rel.rid[order] != INVALID
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = skey[1:] != skey[:-1]
    gid = (torch.cumsum(first, 0, dtype=torch.int32) - 1).to(torch.int32)
    ukeys = torch.full((num_slots,), GROUP_PAD_KEY, dtype=torch.int32,
                       device=dev)
    # Equal keys share a slot and write equal values: any writer wins.
    ukeys[gid.clamp(0, num_slots - 1).to(torch.int64)] = skey
    gid = torch.where(valid, gid, -1)
    if svals.dtype == torch.int64:
        hi = (svals >> 32).to(torch.int32)
        lo = ((svals & 0xFFFFFFFF) - 2**31).to(torch.int32)
        cnt, sm_hi, _, _ = segmented_aggregate(gid, hi, num_slots=num_slots)
        _, sm_lo, _, _ = segmented_aggregate(gid, lo, num_slots=num_slots)
        sm = ((wide_sums_to_int64_tensor(sm_hi) << 32)
              + wide_sums_to_int64_tensor(sm_lo)
              + (cnt.to(torch.int64) << 31))
        mn = torch.full_like(cnt, INT32_MAX)
        mx = torch.full_like(cnt, INT32_MIN)
    else:
        cnt, sm, mn, mx = segmented_aggregate(gid, svals,
                                              num_slots=num_slots,
                                              wrap32=wrap32)
    num_groups = (first & valid).sum(dtype=torch.int32)
    return ukeys, cnt, sm, mn, mx, num_groups


def _gather_values(values: torch.Tensor, rid: torch.Tensor) -> torch.Tensor:
    """values[rid] with pad rows (rid == -1) mapped to 0, gathered on the
    device that holds ``values``, in their dtype."""
    r = rid.to(values.device)
    if values.shape[0] == 0:
        return torch.zeros_like(r, dtype=values.dtype)
    out = values[r.clamp(0, values.shape[0] - 1)]
    return torch.where(r >= 0, out, 0).to(values.dtype)


def _merge_partials(a: GroupByResult, b: GroupByResult) -> GroupByResult:
    """Global aggregation of two partial group lists (separate + merge).

    Row-split partials may share keys; counts/sums add (wide int64 sums
    add exactly; wrap32 partials add in int32 modular arithmetic,
    associative with the per-group wrap), mins/maxs fold.  O(total
    partial groups) on the host.
    """
    keys = np.concatenate([a.keys, b.keys])
    uk, inv = np.unique(keys, return_inverse=True)
    g = uk.shape[0]
    cnt = np.zeros(g, np.int64)
    np.add.at(cnt, inv, np.concatenate([a.counts, b.counts]).astype(np.int64))
    sm = np.zeros(g, np.int64)
    np.add.at(sm, inv, np.concatenate([a.sums, b.sums]).astype(np.int64))
    mn = np.full(g, INT32_MAX, np.int64)
    np.minimum.at(mn, inv, np.concatenate([a.mins, b.mins]).astype(np.int64))
    mx = np.full(g, INT32_MIN, np.int64)
    np.maximum.at(mx, inv, np.concatenate([a.maxs, b.maxs]).astype(np.int64))
    sum_dtype = (np.int64 if a.sums.dtype == np.int64
                 or b.sums.dtype == np.int64 else np.int32)
    return GroupByResult(uk.astype(np.int32), cnt.astype(np.int32),
                         sm.astype(sum_dtype), mn.astype(np.int32),
                         mx.astype(np.int32))


def _collect(pieces, wrap32: bool = True) -> GroupByResult:
    """Concatenate per-group results, dropping empty slots.

    The live slots (count > 0) are found once and compacted, and wide
    sums decoded to int64, on each piece's device; only O(groups) rows
    reach the host, each column in its own width (the copy dominates).
    """
    cols = [[], [], [], [], []]
    for ukeys, cnt, sm, mn, mx, _ in pieces:
        live = torch.nonzero(cnt > 0).squeeze(1)
        sm = sm[live] if sm.dim() == 1 else \
            wide_sums_to_int64_tensor(sm[:, live])
        for out, col in zip(cols, (ukeys[live], cnt[live], sm, mn[live],
                                   mx[live])):
            out.append(col.cpu().numpy())
    keys, cnts, sms, mns, mxs = (
        (np.concatenate(c) if c else np.zeros(0, dt)).astype(dt)
        for c, dt in zip(cols, (np.int32, np.int32,
                                np.int32 if wrap32 else np.int64,
                                np.int32, np.int32)))
    return GroupByResult(keys, cnts, sms, mns, mxs)


def groupby_coprocessed(cp: CoProcessor, rel: Relation, values, *,
                        schedule: tuple[int, ...] | None = None,
                        partition_ratio: float, agg_ratio: float,
                        wrap32: bool = False,
                        ctx=None) -> tuple[GroupByResult, Timing]:
    """Hash group-by of ``values`` by ``rel.key`` across the two groups.

    ``rel.rid`` must index rows of ``values`` (the arange gather
    convention); rid ``INVALID`` marks pad tuples.  ``values`` is a NumPy
    array or a tensor, int32 or int64 (``grouped_agg``); a NumPy column
    goes to ``rel``'s device first, and the gathers run where the values
    lie.  ``partition_ratio`` is the C share of the partition passes and
    ``agg_ratio`` of the reduce (both required: C is the host CPU).  Sums are exact int64 unless
    ``wrap32=True``.  ``ctx`` (a ``QueryContext``) makes the partition
    phase preemptible — pass-at-a-time with ``ctx.check`` at every
    boundary and once more before the aggregate phase.
    """
    timing = Timing(tracer=cp.tracer)
    if not isinstance(values, torch.Tensor):
        values = torch.from_numpy(np.ascontiguousarray(values)).to(
            rel.device)
    values = values.to(torch.int64 if values.dtype == torch.int64
                       else torch.int32)
    if wrap32 and values.dtype == torch.int64:
        raise ValueError("wrap32 sums int32 values; int64 values sum "
                         "exactly")
    if rel.size == 0:
        timing.phase_s["partition"] = 0.0
        timing.phase_s["agg"] = 0.0
        return _collect([], wrap32=wrap32), timing
    rel = cp.pad_relation(rel, GROUP_PAD_KEY)
    if schedule:
        schedule = tuple(schedule)
        timing.notes["schedule"] = list(schedule)
        total_bits = sum(schedule)
        with timing.phase("partition", sync=cp.synchronize,
                          passes=len(schedule)):
            if ctx is not None:
                rel = cp._partition_side_cooperative(
                    "GB", rel, schedule, partition_ratio, ctx, 0, timing)
            else:
                rel = cp._collect([
                    grp.launch(radix_partition_scheduled)(
                        r, schedule=schedule).rel
                    for grp, r in cp._slices(rel, partition_ratio, timing)])
        if ctx is not None:
            ctx.check("agg")
        with timing.phase("agg", sync=cp.synchronize):
            # Ownership exchange: partitions [0, own) -> C, rest -> G
            # (phj's join-phase split, applied to the reduce).
            num_parts = 1 << total_bits
            own = cp._cut(num_parts, agg_ratio)
            pid = radix_of(rel.key, shift=0, bits=total_bits)
            outs = []
            for grp, lo, hi in ((cp.c, 0, own), (cp.g, own, num_parts)):
                if lo == hi:
                    continue
                sub, k = owned_slice(rel, pid, lo, hi, cp.lcm,
                                     GROUP_PAD_KEY)
                if cp.discrete:
                    cp._bus_delay(k * 8 // 2, timing)
                vals = _gather_values(values, sub.rid)
                outs.append(grp.launch(grouped_agg)(
                    grp.put_items(sub), grp.put_items(vals),
                    num_slots=sub.size, wrap32=wrap32))
            result = _collect(outs, wrap32=wrap32)
    else:
        timing.phase_s["partition"] = 0.0
        if ctx is not None:
            ctx.check("agg")
        with timing.phase("agg", sync=cp.synchronize):
            n = rel.size
            cut = cp._cut(n, agg_ratio)
            vals = _gather_values(values, rel.rid)
            if 0 < cut < n:
                # Separate partial aggregation + host merge: each group
                # builds a partial group list on its row share.
                if cp.discrete:
                    cp._bus_delay((n - cut) * 8, timing)
                shares = ((cp.c, 0, cut), (cp.g, cut, n))
            else:
                grp = cp.c if cut == n else cp.g
                if cp.discrete and grp is cp.g:
                    cp._bus_delay(n * 8, timing)
                shares = ((grp, 0, n),)
            outs = [grp.launch(grouped_agg)(
                grp.put_items(rel.take(lo, hi)),
                grp.put_items(vals[lo:hi]), num_slots=hi - lo, wrap32=wrap32)
                for grp, lo, hi in shares]
            if len(outs) == 2:
                tm = time.perf_counter()
                result = _merge_partials(_collect(outs[:1], wrap32=wrap32),
                                         _collect(outs[1:], wrap32=wrap32))
                timing.merge_s = time.perf_counter() - tm
            else:
                result = _collect(outs, wrap32=wrap32)
    timing.wall_s = timing.phase_s["partition"] + timing.phase_s["agg"]
    timing.notes["num_groups"] = result.num_groups
    return result, timing


# ---------------------------------------------------------------------------
# NumPy oracle (testing/verification only).
# ---------------------------------------------------------------------------

def groupby_ref(keys, values, *, wrap32: bool = False) -> GroupByResult:
    """Exact group-by oracle: key-sorted groups.

    Sums are exact int64 by default; ``wrap32=True`` reproduces the legacy
    int32-wrapping device accumulator exactly.
    """
    keys = np.asarray(keys)
    values = np.asarray(values, dtype=np.int64)
    uk, inv = np.unique(keys, return_inverse=True)
    g = uk.shape[0]
    cnt = np.bincount(inv, minlength=g).astype(np.int32)
    sm = np.zeros(g, np.int64)
    np.add.at(sm, inv, values)
    mn = np.full(g, INT32_MAX, np.int64)
    np.minimum.at(mn, inv, values)
    mx = np.full(g, INT32_MIN, np.int64)
    np.maximum.at(mx, inv, values)
    return GroupByResult(uk.astype(np.int32), cnt,
                         sm.astype(np.int32) if wrap32 else sm,
                         mn.astype(np.int32), mx.astype(np.int32))


CoProcessor.groupby = groupby_coprocessed
