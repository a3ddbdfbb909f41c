"""The card's peaks and the bytes the port's join kernels A-F must move.

A kernel's bound is its bytes over the card's memory bandwidth; each
input byte is counted once and each output byte once, whatever the
kernel reads again or keeps in scratch.  Peaks are NVIDIA's for the H100
SXM5 80 GB (data sheet, at its 700 W limit).

The CUDA functions each kernel launches, by the identifier the profiler
shows (``csrc/*.cu``), map back to the kernel letter in ``KERNEL_OF``.
"""
from __future__ import annotations

import re

HBM_BYTES_PER_S = 3.35e12

KERNEL_OF = {
    "fused_kernel": "A",                             # partition_hist_fused
    "tile_hist_shared": "B", "tile_scan_rows": "B", "scatter_shared": "B",
    "tile_hist_device": "B", "tile_scan_warps": "B",
    "scatter_device": "B",                           # radix_scatter
    "init_kernel": "C", "seg_agg_kernel": "C",       # seg_agg
    "hash_kernel": "D",                              # hash_bucket
    "hist_kernel": "E",                              # radix_hist
    "ws_kernel": "F", "probe_kernel": "F",           # partitioned_probe
}
# The program's launch counters (``repro_torch.kernels.launch_counts``)
# count wrapper calls under these names.
COUNTER_OF = {"A": "partition_hist_fused", "B": "radix_scatter",
              "C": "seg_agg", "D": "hash_bucket", "E": "radix_hist",
              "F": "partitioned_probe"}


def function_name(kernel: str) -> str:
    """The bare function name of a profiler kernel name, e.g.
    ``void (anonymous namespace)::hist_kernel<true>(int const*, ...)``
    gives ``hist_kernel``."""
    head = kernel.replace("(anonymous namespace)::", "").split("(", 1)[0]
    head = re.sub(r"<.*", "", head).split("::")[-1].split()
    return head[-1] if head else kernel


def kernel_letter(kernel: str) -> str | None:
    """A-F for a launch of the port's join kernels (all of them live in
    an anonymous namespace), else None."""
    if "(anonymous namespace)::" not in kernel:
        return None
    return KERNEL_OF.get(function_name(kernel))


def bytes_a(n: int, bits: int) -> int:
    """A, n1+n2 fused: reads n keys; writes n pids and the 2^bits
    histogram."""
    return 8 * n + 4 * (1 << bits)


def bytes_b(n: int, parts: int) -> int:
    """B, stable scatter: reads rid, key, pid and the ``parts`` starts;
    writes rid and key."""
    return 20 * n + 4 * parts


def bytes_c(n: int, slots: int, sum_rows: int) -> int:
    """C, segmented aggregation: reads gid and value; writes count, min,
    max and ``sum_rows`` sum channels per slot."""
    return 8 * n + 4 * slots * (3 + sum_rows)


def bytes_d(n: int) -> int:
    """D, bucket number: reads n keys, writes n bucket ids."""
    return 8 * n


def bytes_e(n: int, parts: int) -> int:
    """E, histogram: reads n pids, writes ``parts`` counts."""
    return 4 * n + 4 * parts


def bytes_f(parts: int, table_len: int, probe_len: int) -> int:
    """F, partitioned probe: reads the (P, K) keys and rids and the
    (P, M) probe keys; writes the (P, M) matches."""
    return 8 * parts * table_len + 8 * parts * probe_len


def bound_s(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S


def _cut(n: int, ratio: float, quantum: int = 64) -> int:
    """The C group's share of ``n`` items, as ``CoProcessor._cut`` rounds
    it (group sizes of one device each)."""
    if ratio <= 0.0:
        return 0
    if ratio >= 1.0:
        return n
    q = max(1, n // quantum)
    return min(n, max(0, int(round(ratio * n / q)) * q))


def phj_query_launches(build_n: int, probe_n: int, schedule, *,
                       partition_ratio: float, join_ratio: float,
                       build_layout_hit: bool, probe_layout_hit: bool
                       ) -> list[tuple[str, int]]:
    """``(kernel, bytes)`` of every A-F launch on the card of one PHJ
    query through ``CoProcessor.phj``, from its sizes and plan.

    Partitioning: each side the cache did not hold runs, on the card's
    share of its tuples, A and B once per pass and then that share's
    headers, D and E.  Join: D for the partition ids of both sides and D
    for the bucket ids of both sides.  Only a join phase wholly on the
    card (``join_ratio`` 0) has sizes known from the plan: a share owned
    by the host depends on the data, and raises.
    """
    if join_ratio > 0.0:
        raise ValueError("join phase split by partition ownership: the "
                         "card's share depends on the data")
    total = sum(schedule)
    out = []
    for n, hit in ((build_n, build_layout_hit), (probe_n, probe_layout_hit)):
        g = 0 if hit else n - _cut(n, partition_ratio)
        if g:
            for bits in schedule:
                out.append(("A", bytes_a(g, bits)))
                out.append(("B", bytes_b(g, 1 << bits)))
            out.append(("D", bytes_d(g)))
            out.append(("E", bytes_e(g, 1 << total)))
    for n in (build_n, probe_n, build_n, probe_n):
        out.append(("D", bytes_d(n)))
    return out
