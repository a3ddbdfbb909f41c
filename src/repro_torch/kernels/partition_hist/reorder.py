"""Kernel B: radix-partition step n3, the stable scatter of ``(rid, key)``.

Counterpart of ``repro/kernels/partition_hist/reorder.py``.  On CUDA
tensors ``radix_scatter`` launches ``csrc/radix_scatter.cu`` (per-tile
histograms, a scan across tiles, a stable scatter) at any ``n``; on CPU
tensors it runs ``radix_scatter_plain``, a stable sort by ``pid`` plus
gathers.  Both equal a stable sort bit for bit.

Up to ``SHARED_MAX_PARTS`` partitions the kernel ranks a tile of
``SHARED_TILE`` tuples in shared memory and writes it back partition by
partition; wider fanouts keep their cursors in device memory, with tiles
of ``8 * num_parts`` tuples.
"""
from __future__ import annotations

import torch

from .._build import I32, I64, PTR, kernel, launch

SHARED_MAX_PARTS = 2048   # csrc/radix_scatter.cu: shared-memory path
SHARED_TILE = 4096        # its tile: 256 threads x 16 tuples


def uses_shared(num_parts: int) -> bool:
    """Whether ``num_parts`` partitions take the shared-memory path."""
    return num_parts <= SHARED_MAX_PARTS


def tile_len(num_parts: int) -> int:
    """Tuples per tile: ``SHARED_TILE`` on the shared-memory path; on the
    device-memory path it grows with the fanout, so the (num_parts x
    tiles) offset matrix stays at n/8 ints."""
    return SHARED_TILE if uses_shared(num_parts) else 8 * num_parts


def scratch_ints(n: int, num_parts: int) -> int:
    """int32 entries of the kernel's (num_parts x tiles) offset matrix."""
    return num_parts * max(1, -(-n // tile_len(num_parts)))


def radix_scatter_plain(rid: torch.Tensor, key: torch.Tensor,
                        pid: torch.Tensor, starts=None, *, num_parts: int = 0):
    """Plain version: tuples in stable ``pid`` order (``starts`` unused)."""
    order = torch.sort(pid, stable=True).indices
    return rid[order], key[order]


def radix_scatter(rid: torch.Tensor, key: torch.Tensor, pid: torch.Tensor,
                  starts: torch.Tensor, *, num_parts: int):
    """Stable scatter of tuples to ``starts[pid] + rank within pid``.

    rid/key/pid: (n,) int32 with every pid in [0, num_parts); starts:
    (num_parts,) int32, the exclusive scan of pid's histogram.  Returns the
    reordered ``(rid, key)``, bit-identical to a stable sort by pid.
    """
    if num_parts < 1 or num_parts & (num_parts - 1):
        raise ValueError(f"num_parts must be a power of two: {num_parts}")
    devices = {t.device for t in (rid, key, pid, starts)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    dev = pid.device
    if dev.type == "cpu":
        return radix_scatter_plain(rid, key, pid, starts,
                                   num_parts=num_parts)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = pid.shape[0]
    for name, t, size in (("rid", rid, n), ("key", key, n), ("pid", pid, n),
                          ("starts", starts, num_parts)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous() or t.shape[0] != size:
            raise ValueError(f"{name} must be contiguous of shape ({size},)")
    if n >= 1 << 31:
        raise ValueError(f"n={n} needs int64 offsets")
    tile = tile_len(num_parts)
    offs = torch.empty(scratch_ints(n, num_parts), dtype=torch.int32,
                       device=dev)
    out_rid = torch.empty_like(rid)
    out_key = torch.empty_like(key)
    launch(kernel("radix_scatter", "radix_scatter", *[PTR] * 7, I64, I32,
                  I64, PTR),
           dev, rid.data_ptr(), key.data_ptr(), pid.data_ptr(),
           starts.data_ptr(), offs.data_ptr(), out_rid.data_ptr(),
           out_key.data_ptr(), n, num_parts.bit_length() - 1, tile)
    return out_rid, out_key
