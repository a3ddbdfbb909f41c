"""Radix partitioning (paper §3.1, Algorithm 2, steps n1..n3).

Counterpart of ``repro/core/partition.py``.  Each pass clusters tuples by
a slice of the hash's bits:

  n1: compute partition number        (kernel A on CUDA; D for headers)
  n2: visit the partition header      (histogram, kernel A or E; scan)
  n3: insert <key, rid> into partition (stable scatter, kernel B on CUDA)

Pass ``g`` uses hash bits ``[shift_g, shift_g + bits_g)`` and a globally
stable reorder, so after all passes tuples are clustered by the full
``sum(schedule)``-bit radix.  On CPU tensors the passes run the kernels'
plain versions.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels.partition_hist.ops import fused_partition_pass, radix_hist_op
from .relation import Relation, radix_of


@dataclasses.dataclass
class Partitions:
    """A relation clustered into ``P`` partitions, with CSR headers."""

    rel: Relation               # tuples reordered so partitions are contiguous
    part_start: torch.Tensor    # (P,)
    part_count: torch.Tensor    # (P,)

    @property
    def num_partitions(self) -> int:
        return int(self.part_start.shape[0])


def partition_n1(key: torch.Tensor, *, shift: int, bits: int) -> torch.Tensor:
    """(n1) compute partition number from the hash's bit slice."""
    return radix_of(key, shift=shift, bits=bits)


def partition_n2(pid: torch.Tensor, num_parts: int):
    """(n2) partition headers: histogram (kernel E on CUDA) + exclusive
    scan (the allocator).  E goes through its custom op, whose fake
    kernel gives the headers' shape to a trace under ``FakeTensorMode``."""
    counts = radix_hist_op(pid, num_parts)
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    return starts, counts


def partition_n3(rel: Relation, pid: torch.Tensor) -> Relation:
    """(n3) insert <key, rid> into partitions: stable reorder by pid."""
    order = torch.sort(pid, stable=True).indices
    return Relation(rel.rid[order], rel.key[order])


def _headers(rel: Relation, total_bits: int) -> Partitions:
    full_pid = radix_of(rel.key, shift=0, bits=total_bits)
    start, count = partition_n2(full_pid, 1 << total_bits)
    return Partitions(rel, start, count)


def partition_pass(rel: Relation, *, shift: int, bits: int) -> Relation:
    """One fused partition pass (n1+n2 kernel, scan + stable scatter n3)."""
    out, _, _ = fused_partition_pass(rel, shift=shift, bits=bits)
    return out


def radix_partition_scheduled(rel: Relation, *,
                              schedule: tuple[int, ...]) -> Partitions:
    """Multi-pass radix partitioning over an explicit pass ``schedule``
    (each pass's digit width, low digit first: a ``PassPlan.schedule``)."""
    return radix_partition_cooperative(rel, schedule=schedule)


def radix_partition_cooperative(rel: Relation, *,
                                schedule: tuple[int, ...],
                                start_pass: int = 0,
                                check=None) -> Partitions:
    """Preemptible multi-pass partitioning.

    Calls ``check(pass_idx)`` before each pass; a check that raises aborts
    with ``pass_idx`` passes complete.  ``start_pass=k`` resumes a relation
    that already absorbed the schedule's first ``k`` passes: each pass is
    a stable reorder on its own bit slice, so completed passes never need
    re-running.  (PyTorch runs eagerly, so this is also the whole-schedule
    path; the JAX package compiles that one into a single program.)
    """
    cur = rel
    shift = sum(schedule[:start_pass])
    for i in range(start_pass, len(schedule)):
        if check is not None:
            check(i)
        cur = partition_pass(cur, shift=shift, bits=schedule[i])
        shift += schedule[i]
    return _headers(cur, sum(schedule))


def radix_partition(rel: Relation, *, bits_per_pass: int,
                    num_passes: int) -> Partitions:
    """Uniform-schedule partitioning: (n1 n2 n3) x num_passes (fused)."""
    return radix_partition_scheduled(rel,
                                     schedule=(bits_per_pass,) * num_passes)


def radix_partition_unfused(rel: Relation, *, bits_per_pass: int,
                            num_passes: int) -> Partitions:
    """The materialized 3-step path (n1, n2, n3 as separate plain ops),
    kept as the baseline the fused path is compared with."""
    cur = rel
    for g in range(num_passes):
        pid = partition_n1(cur.key, shift=g * bits_per_pass,
                           bits=bits_per_pass)
        # Headers are computed every pass (n2) as in the paper; only the
        # final pass's full-radix headers are returned.
        partition_n2(pid, 1 << bits_per_pass)
        cur = partition_n3(cur, pid)
    return _headers(cur, bits_per_pass * num_passes)


def partition_ids(rel: Relation, *, total_bits: int) -> torch.Tensor:
    """Final partition id per tuple (for tests / divergence grouping)."""
    return radix_of(rel.key, shift=0, bits=total_bits)
