"""Partitioned (radix) hash join: paper Algorithm 2.

Counterpart of ``repro/core/phj.py``.  PHJ = g passes of radix
partitioning on R and S (steps n1..n3 per pass, kernels A and B on CUDA),
then SHJ per partition pair.  Both relations are clustered by the same
radix bits, so the per-partition SHJ is one global CSR hash join whose
bucket id is ``(radix_value << shj_bits) | shj_hash_bits``: buckets never
span partitions, so probes stay within their partition pair.

Two step granularities (paper §3.3):
  * fine-grained   : per-tuple steps (n1..n3, b1..b4, p1..p4), PHJ-PL;
  * coarse-grained : one step per partition pair, each joined with its own
    private table, PHJ-PL' (Table 3 baseline).
"""
from __future__ import annotations

import torch

from ..kernels.csr_probe import EXPAND_COUNTERS, csr_expand, csr_lookup
from ..obs.trace import NULL_TRACER
from . import hash_table as ht
from .partition import Partitions, partition_n1, partition_n2, partition_n3, \
    radix_partition_scheduled
from .relation import Relation, next_pow2, radix_of
from .steps import Step, StepCost, StepSeries

# Buckets sized for this many tuples each (paper §5.2's bucket-load knob).
DEFAULT_AVG_BUCKET = 4

PARTITION_COSTS = {
    "n1": StepCost(ops_per_item=60, seq_bytes_per_item=12,
                   rand_accesses_per_item=0.0, out_bytes_per_item=12),
    "n2": StepCost(ops_per_item=4, seq_bytes_per_item=4,
                   rand_accesses_per_item=0.5, out_bytes_per_item=12),
    "n3": StepCost(ops_per_item=40, seq_bytes_per_item=16,
                   rand_accesses_per_item=1.0, out_bytes_per_item=8,
                   workload_dependent=True),
}


def _n1(shared, items):
    pid = partition_n1(items["key"], shift=shared["shift"],
                       bits=shared["bits"])
    return {**items, "pid": pid}, {}


def _n2(shared, items):
    _, counts = partition_n2(items["pid"], 1 << shared["bits"])
    return items, {"part_hist": counts}


def _n3(shared, items):
    rel = partition_n3(Relation(items["rid"], items["key"]), items["pid"])
    return {"rid": rel.rid, "key": rel.key}, {}


def partition_series(pass_idx: int) -> StepSeries:
    return StepSeries(f"phj_partition_pass{pass_idx}", (
        Step("n1", _n1, PARTITION_COSTS["n1"]),
        Step("n2", _n2, PARTITION_COSTS["n2"], combine={"part_hist": "add"}),
        Step("n3", _n3, PARTITION_COSTS["n3"]),
    ))


def phj_bucket_count(n: int, total_radix_bits: int, *,
                     avg_bucket: int = DEFAULT_AVG_BUCKET):
    """Buckets per partition (power of two)."""
    per_part = max(1, n >> total_radix_bits)
    return max(1, next_pow2(max(1, per_part // avg_bucket)))


def default_shj_bits(n: int, total_radix_bits: int, *,
                     avg_bucket: int = DEFAULT_AVG_BUCKET) -> int:
    """Sub-bucket bits per partition, from the bucket-count heuristic."""
    return max(0, phj_bucket_count(n, total_radix_bits,
                                   avg_bucket=avg_bucket).bit_length() - 1)


def resolve_schedule(n: int, *, bits_per_pass: int | None = None,
                     num_passes: int | None = None,
                     schedule: tuple[int, ...] | None = None,
                     planner=None) -> tuple[int, ...]:
    """The ONE place pass knobs are decided.

    Priority: explicit ``schedule`` > explicit ``bits_per_pass`` x
    ``num_passes`` > the cost-model-guided ``PassPlanner`` for ``n``.
    """
    if schedule is not None:
        sched = tuple(int(b) for b in schedule)
    elif bits_per_pass is not None:
        sched = (int(bits_per_pass),) * int(num_passes or 1)
    else:
        if planner is None:
            from .pass_planner import default_planner
            planner = default_planner()
        if num_passes is not None:
            # Honor the requested pass count: split the planner's total
            # radix width into that many near-even digits.
            from .pass_planner import even_schedule
            total = max(int(num_passes), planner.choose_total_bits(n))
            sched = even_schedule(total, int(num_passes))
        else:
            sched = planner.plan(n).schedule
    if not sched or any(b < 1 for b in sched):
        raise ValueError(f"each pass needs >= 1 radix bit: {sched}")
    return sched


def schedule_prefixes(schedule: tuple[int, ...]):
    """Proper prefixes of a pass schedule, longest first (the engine's
    checkpoint/resume keys)."""
    sched = tuple(int(b) for b in schedule)
    return [sched[:k] for k in range(len(sched) - 1, 0, -1)]


def partition_bucket_ids(key: torch.Tensor, *, total_bits: int,
                         shj_bits: int) -> torch.Tensor:
    """Partition-aligned bucket id ``(part << shj_bits) | sub``, in uint32
    arithmetic (held in int64) and returned as int32."""
    part = radix_of(key, shift=0, bits=total_bits).to(torch.int64)
    if shj_bits:
        sub = radix_of(key, shift=total_bits, bits=shj_bits).to(torch.int64)
    else:
        sub = 0
    return (((part << shj_bits) | sub) & 0xFFFFFFFF).to(torch.int32)


def partitioned_join(rel_r: Relation, rel_s: Relation, *, total_bits: int,
                     shj_bits: int, max_out: int,
                     tracer=NULL_TRACER) -> ht.JoinResult:
    """SHJ of relations clustered by ``total_bits`` radix bits, with
    buckets aligned to partitions.  Build on R: its tuples are clustered,
    so the (bucket, key) order inside the build is near-sorted.

    The probe is ``csr_probe_join``'s lookup and expand: on a CUDA device
    the kernels of ``csrc/csr_probe.cu``, on the CPU p2 -> p3 -> p4.
    ``tracer`` spans the build (``join.build``: bucket ids, b2-b4) and
    the probe (``join.probe``: bucket ids, lookup, then ``join.expand``:
    scan and expand), device-timed on a CUDA device; ``join.expand``
    carries the expand's ``EXPAND_COUNTERS``, counted where it runs."""
    dev = rel_r.key.device
    num_buckets = 1 << (total_bits + shj_bits)
    with tracer.span("join.build", device=dev):
        bkt = partition_bucket_ids(rel_r.key, total_bits=total_bits,
                                   shj_bits=shj_bits)
        table = ht.table_from_buckets(rel_r, bkt, num_buckets)
    with tracer.span("join.probe", device=dev):
        pbkt = partition_bucket_ids(rel_s.key, total_bits=total_bits,
                                    shj_bits=shj_bits)
        entry, nmatch = csr_lookup(table, pbkt, rel_s.key)
        with tracer.span("join.expand", device=dev) as span:
            counters = None if span is None else torch.zeros(
                len(EXPAND_COUNTERS), dtype=torch.int64, device=dev)
            out = csr_expand(table, rel_s.rid, entry, nmatch, max_out,
                             counters=counters)
            if span is not None:
                span.count(EXPAND_COUNTERS, counters)
        return out


def phj_join(build_rel: Relation, probe_rel: Relation, *,
             bits_per_pass: int | None = None, num_passes: int | None = None,
             schedule: tuple[int, ...] | None = None, planner=None,
             buckets_per_part: int | None = None,
             max_out: int) -> ht.JoinResult:
    """Full PHJ: partition R and S, then SHJ per partition pair (fused).

    Pass knobs may be given or left to the planner; ``buckets_per_part``
    defaults from the planned radix width.  Runs on the relations' device.
    """
    sched = resolve_schedule(build_rel.size, bits_per_pass=bits_per_pass,
                             num_passes=num_passes, schedule=schedule,
                             planner=planner)
    if buckets_per_part is None:
        buckets_per_part = phj_bucket_count(build_rel.size, sum(sched))
    return _phj_join_scheduled(build_rel, probe_rel, schedule=sched,
                               buckets_per_part=buckets_per_part,
                               max_out=max_out)


def _phj_join_scheduled(build_rel: Relation, probe_rel: Relation, *,
                        schedule: tuple[int, ...], buckets_per_part: int,
                        max_out: int) -> ht.JoinResult:
    pr = radix_partition_scheduled(build_rel, schedule=schedule)
    ps = radix_partition_scheduled(probe_rel, schedule=schedule)
    return partitioned_join(pr.rel, ps.rel, total_bits=sum(schedule),
                            shj_bits=max(0, buckets_per_part.bit_length() - 1),
                            max_out=max_out)


# --------------------------------------------------------------------------
# Coarse-grained step definition (paper §3.3, PHJ-PL' in Table 3).
# --------------------------------------------------------------------------

def phj_coarse_join(pr: Partitions, ps: Partitions, *, num_parts: int,
                    part_cap: int, buckets_per_part: int,
                    max_out_per_part: int) -> ht.JoinResult:
    """Join each partition pair as ONE item with its own private table.

    Partitions are padded to ``part_cap``; the JAX package vmaps over the
    pairs, this loops over them and concatenates in the same order.
    """
    dev = pr.rel.device
    lane = torch.arange(part_cap, dtype=torch.int32, device=dev)

    def gather_part(parts: Partitions, i: int, pad_key: int) -> Relation:
        valid = lane < parts.part_count[i]
        idx = (parts.part_start[i] + lane).clamp(0, parts.rel.size - 1)
        # Padding gets a sentinel key that matches nothing (build -2,
        # probe -3) and rid -1.
        key = torch.where(valid, parts.rel.key[idx], pad_key)
        rid = torch.where(valid, parts.rel.rid[idx], ht.INVALID)
        return Relation(rid, key)

    results = []
    for i in range(num_parts):
        table = ht.build_hash_table(gather_part(pr, i, -2), buckets_per_part)
        results.append(ht.probe_hash_table(gather_part(ps, i, -3), table,
                                           max_out_per_part))
    probe = torch.cat([r.probe_rid for r in results])
    build = torch.cat([r.build_rid for r in results])
    count = torch.stack([r.count for r in results]).sum(dtype=torch.int32)
    order = torch.sort((probe == ht.INVALID).to(torch.int8),
                       stable=True).indices
    return ht.JoinResult(probe[order], build[order], count)
