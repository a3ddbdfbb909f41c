"""Scan-based dynamic memory allocator (paper §3.3 "Memory allocator").

Counterpart of ``repro/core/allocator.py``.  OpenCL 1.2 has no in-kernel
malloc, so the paper pre-allocates an array and serves requests by
advancing a pointer with atomics; its optimized version allocates *blocks*
per work group to cut atomic contention.

The allocator here is the same deterministic two-level exclusive scan over
the request sizes as the JAX package's:

  level 1 (per tile)  — requests within a tile (≙ work group) are packed by
                         a local exclusive scan;
  level 2 (global)    — each tile claims one *block-rounded* extent from the
                         global buffer via a scan over per-tile totals.

The block size plays the paper's role: bigger blocks mean fewer global
allocation units (its "atomics") at the price of internal fragmentation.
``AllocStats.global_units`` is the contention proxy the Fig. 11
reproduction sweeps.  Every sum and scan is int32, so sizes wrap exactly
as the reference's do; the work runs on the device that holds ``sizes``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass
class AllocStats:
    global_units: int        # number of block claims (≙ global atomics)
    allocated_bytes: int     # buffer actually claimed incl. fragmentation
    requested_bytes: int
    fragmentation: float


def _int32(sizes) -> torch.Tensor:
    """``sizes`` as a tensor, integers narrowed to int32 (the reference's
    ``jnp.asarray`` with 64-bit types off)."""
    t = torch.as_tensor(sizes)
    if not t.dtype.is_floating_point and t.dtype != torch.int32:
        t = t.to(torch.int32)
    return t


def scan_alloc(sizes, *, tile: int = 256, block_items: int = 256):
    """Offsets for per-item allocation requests.

    Returns (offsets, total_items_allocated), int32 tensors on ``sizes``'
    device.  Offsets honor the two-level structure: items within a tile
    are contiguous; tiles start at block-rounded boundaries.
    """
    sizes = torch.as_tensor(sizes)
    n = sizes.shape[0]
    pad = (-n) % tile
    s = F.pad(sizes.to(torch.int32), (0, pad)).reshape(-1, tile)
    local = torch.cumsum(s, dim=1, dtype=torch.int32) - s    # level-1 scan
    tile_need = s.sum(dim=1, dtype=torch.int32)
    tile_alloc = ((tile_need + block_items - 1) // block_items) * block_items
    tile_base = torch.cumsum(tile_alloc, 0, dtype=torch.int32) - tile_alloc
    offs = (tile_base[:, None] + local).reshape(-1)[:n]      # level-2 scan
    return offs, tile_alloc.sum(dtype=torch.int32)


def alloc_stats(sizes, *, tile: int = 256, block_items: int = 256,
                item_bytes: int = 8) -> AllocStats:
    sizes = _int32(sizes)
    _, total = scan_alloc(sizes, tile=tile, block_items=block_items)
    n_tiles = -(-sizes.shape[0] // tile)
    req = int(sizes.sum(dtype=sizes.dtype)) * item_bytes
    alloc = int(total) * item_bytes
    return AllocStats(global_units=n_tiles, allocated_bytes=alloc,
                      requested_bytes=req,
                      fragmentation=0.0 if alloc == 0 else 1 - req / alloc)


def basic_alloc_units(sizes) -> int:
    """The paper's basic allocator: one global claim per request."""
    return int((_int32(sizes) > 0).sum())
