"""Simple hash join (SHJ) as two fine-grained step series (paper Alg. 1).

Counterpart of ``repro/core/shj.py``: build series b1..b4 and probe series
p1..p4 with a barrier in between.  Each step's ``apply`` runs on any
contiguous slice of items, which is what lets the co-processing schemes
ratio-split them across processor groups.
"""
from __future__ import annotations

import torch

from . import hash_table as ht
from .relation import Relation
from .steps import Step, StepCost, StepSeries

# Per-item cost coefficients (paper Table 2's profiled #I and the memory
# unit costs; analytic seeds that calibrate.py replaces with measurements).
COSTS = {
    "b1": StepCost(ops_per_item=60, seq_bytes_per_item=12,
                   rand_accesses_per_item=0.0, out_bytes_per_item=12),
    "b2": StepCost(ops_per_item=48, seq_bytes_per_item=24,
                   rand_accesses_per_item=0.0, out_bytes_per_item=12,
                   workload_dependent=True),
    "b3": StepCost(ops_per_item=12, seq_bytes_per_item=20,
                   rand_accesses_per_item=0.5, out_bytes_per_item=16,
                   workload_dependent=True),
    "b4": StepCost(ops_per_item=4, seq_bytes_per_item=8,
                   rand_accesses_per_item=1.0, out_bytes_per_item=8),
    "p1": StepCost(ops_per_item=60, seq_bytes_per_item=12,
                   rand_accesses_per_item=0.0, out_bytes_per_item=12),
    "p2": StepCost(ops_per_item=4, seq_bytes_per_item=8,
                   rand_accesses_per_item=1.0, out_bytes_per_item=20),
    "p3": StepCost(ops_per_item=24, seq_bytes_per_item=4,
                   rand_accesses_per_item=3.0, out_bytes_per_item=12,
                   workload_dependent=True),
    "p4": StepCost(ops_per_item=8, seq_bytes_per_item=16,
                   rand_accesses_per_item=2.0, out_bytes_per_item=8),
}


# --------------------------------------------------------------------------
# Build steps.
# --------------------------------------------------------------------------

def _b1(shared, items):
    bkt = ht.build_b1(items["key"], shared["num_buckets"])
    return {**items, "bkt": bkt}, {}


def _b2(shared, items):
    """Stable (bucket, key) order over the slice, plus the bucket histogram
    partial (combined by "add" across groups)."""
    order = ht.build_b2_order(items["bkt"], items["key"])
    out = {k: v[order] for k, v in items.items()}
    hist = torch.bincount(items["bkt"], minlength=shared["num_buckets"]) \
        .to(torch.int32)
    return out, {"hist": hist}


def _b3(shared, items):
    key, bkt = items["key"], items["bkt"]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=key.device),
                       (bkt[1:] != bkt[:-1]) | (key[1:] != key[:-1])])
    return {**items, "first": first[:key.shape[0]]}, {}


def _b4(shared, items):
    """Finalize the slice's partial CSR table (b4: insert rids)."""
    nb = shared["num_buckets"]
    (ukeys, krs, krc, bks, bkc, num_keys) = ht.build_b3_keylists(
        items["bkt"], items["key"], nb)
    table = ht.HashTable(bks, bkc, ukeys, krs, krc, items["rid"],
                         items["key"], num_keys)
    return {}, {"partial_tables": [table]}


# --------------------------------------------------------------------------
# Probe steps.
# --------------------------------------------------------------------------

def _p1(shared, items):
    bkt = ht.probe_p1(items["key"], shared["table"].num_buckets)
    return {**items, "bkt": bkt}, {}


def _p2(shared, items):
    kstart, kcount = ht.probe_p2(shared["table"], items["bkt"])
    return {**items, "kstart": kstart, "kcount": kcount}, {}


def _p3(shared, items):
    entry, nmatch = ht.probe_p3(shared["table"], items["key"],
                                items["kstart"], items["kcount"])
    return {**items, "entry": entry, "nmatch": nmatch}, {}


def _p4(shared, items):
    res = ht.probe_p4(shared["table"], items["rid"], items["entry"],
                      items["nmatch"], shared["max_out"])
    return {}, {"results": [res]}


BUILD_SERIES = StepSeries("shj_build", (
    Step("b1", _b1, COSTS["b1"]),
    Step("b2", _b2, COSTS["b2"], combine={"hist": "add"}),
    Step("b3", _b3, COSTS["b3"]),
    Step("b4", _b4, COSTS["b4"], combine={"partial_tables": "list"}),
))

PROBE_SERIES = StepSeries("shj_probe", (
    Step("p1", _p1, COSTS["p1"]),
    Step("p2", _p2, COSTS["p2"]),
    Step("p3", _p3, COSTS["p3"]),
    Step("p4", _p4, COSTS["p4"], combine={"results": "list"}),
))


# --------------------------------------------------------------------------
# Single-device reference SHJ.
# --------------------------------------------------------------------------

def shj_join(build_rel: Relation, probe_rel: Relation, *, num_buckets: int,
             max_out: int) -> ht.JoinResult:
    table = ht.build_hash_table(build_rel, num_buckets)
    return ht.probe_hash_table(probe_rel, table, max_out)


def concat_results(parts: list[ht.JoinResult],
                   max_out: int) -> ht.JoinResult:
    """Combine per-group probe outputs (order: C-group first), with the
    valid pairs compacted to the front by a stable sort."""
    probe = torch.cat([p.probe_rid for p in parts])
    build = torch.cat([p.build_rid for p in parts])
    count = sum(p.count for p in parts)
    invalid = (probe == ht.INVALID).to(torch.int8)
    order = torch.sort(invalid, stable=True).indices
    probe, build = probe[order][:max_out], build[order][:max_out]
    return ht.JoinResult(probe, build,
                         torch.clamp(count, max=max_out).to(torch.int32))
