"""Dispatcher and device-side packing of a partitioned probe problem.

Counterpart of ``repro/kernels/probe/ops.py``.  ``probe`` is kernel F on
CUDA tensors and its plain version on CPU tensors.
``build_partitioned_table`` packs two relations into the kernel's layout
on the device that holds them: the JAX package packs on the host with one
mask per partition, O(P n), which does not scale to P = 2^13 and
n = 2^24.
"""
from __future__ import annotations

import torch

from ..partition_hist.partition_hist import radix_hist
from .probe import PAD_KEY, _u32, probe

__all__ = ["build_partitioned_table", "probe"]


def _round_up(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def _pack(rel, pid: torch.Tensor, counts: torch.Tensor,
          sort_key: torch.Tensor, cap: int, key_pad: int):
    """Rows of ``cap`` slots, one per partition: tuples in the order of a
    stable sort by ``sort_key`` (which must order by pid first), placed by
    one scatter, pads elsewhere."""
    p = counts.shape[0]
    dev = rel.device
    order = torch.sort(sort_key, stable=True).indices
    spid = pid[order].to(torch.int64)
    starts = torch.cumsum(counts, 0) - counts
    slot = spid * cap + (torch.arange(rel.size, device=dev) - starts[spid])
    keys = torch.full((p * cap,), key_pad, dtype=torch.int32, device=dev)
    rids = torch.full((p * cap,), -1, dtype=torch.int32, device=dev)
    keys[slot] = rel.key[order]
    rids[slot] = rel.rid[order]
    return keys.view(p, cap), rids.view(p, cap)


def build_partitioned_table(build, probe_rel, *, total_bits: int):
    """(P, K) sorted build keys and rids, (P, M) probe keys and rids.

    P = 2^total_bits partitions by ``radix_of(key, shift=0)``; K and M are
    the largest partition of each side, at least 8, rounded up to a
    multiple of 128.  Build rows are sorted by key as uint32 with equal
    keys in input order and padded with (INT_MAX, -1); probe rows keep
    input order and are padded with (-1, -1).  Both relations must lie on
    one device, where the packing runs; only the two caps leave it.
    """
    # Imported here: repro_torch.core imports the kernels package.
    from repro_torch.core.relation import radix_of

    p = 1 << total_bits
    if build.device != probe_rel.device:
        raise ValueError(f"relations on {build.device} and "
                         f"{probe_rel.device}")
    bpid = radix_of(build.key, shift=0, bits=total_bits)
    ppid = radix_of(probe_rel.key, shift=0, bits=total_bits)
    bcnt = radix_hist(bpid, num_parts=p).to(torch.int64)
    pcnt = radix_hist(ppid, num_parts=p).to(torch.int64)
    k_max, m_max = torch.stack([bcnt.max(), pcnt.max()]).tolist()
    k_cap = _round_up(max(8, k_max), 128)
    m_cap = _round_up(max(8, m_max), 128)
    tk, tr = _pack(build, bpid, bcnt,
                   (bpid.to(torch.int64) << 32) | _u32(build.key), k_cap,
                   PAD_KEY)
    qk, qr = _pack(probe_rel, ppid, pcnt, ppid, m_cap, -1)
    return tk, tr, qk, qr
