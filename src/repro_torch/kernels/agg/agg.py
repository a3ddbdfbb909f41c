"""Kernel C: segmented aggregation (group-by's reduce step).

Counterpart of ``repro/kernels/agg/agg.py``.  Per slot ``gid``, count,
sum, min and max of an int32 value column; tuples whose ``gid`` lies
outside ``[0, num_slots)`` (the pad sentinel -1 among them) contribute
nothing, and empty slots report ``(0, 0, INT32_MAX, INT32_MIN)``.

Sums are wide by default: exact int64 semantics carried as int32
channels, the layout of the JAX package bit for bit.  The value's uint32
image is cut into ``wide_chunk_bits(n)``-bit chunks; channel ``k`` holds
the per-slot sum of chunk ``k`` and the last channel counts negative
values, so ``wide_sums_to_int64`` recovers the signed total.  The chunk
width follows from the row count ``n`` alone, so no channel can overflow
int32.  ``wrap32=True`` keeps one wrapping int32 sum instead.

On a CUDA tensor ``seg_agg`` launches ``csrc/seg_agg.cu`` at any size; on
a CPU tensor it runs ``seg_agg_plain``.  There is no fallback between the
two.
"""
from __future__ import annotations

import numpy as np
import torch

from .._build import I32, I64, PTR, kernel, launch

INT32_MAX = 2**31 - 1
INT32_MIN = -(2**31)

# Wide sums: a b-bit chunk's per-slot sum stays exact while
# (2**b - 1) * tuples_per_slot < 2**31; narrower chunks trade more
# channels for more headroom.  The per-call row count bounds any slot.
WIDE_SUM_MAX_ROWS = (2**31 - 1) // 255        # 8-bit chunks

_MASK32 = 0xFFFFFFFF


def wide_chunk_bits(n: int) -> int:
    """Chunk width whose per-slot sums cannot overflow at ``n`` rows."""
    for bits in (8, 6, 4):
        if n <= (2**31 - 1) // ((1 << bits) - 1):
            return bits
    raise ValueError(
        f"wide segmented sums support up to {(2**31 - 1) // 15} tuples "
        f"per call (got {n}); split the input or pass wrap32=True")


def _num_chunks(bits: int) -> int:
    return -(-32 // bits)


def sum_rows(n: int, wrap32: bool) -> int:
    """Rows of the sum output for ``n`` tuples."""
    return 1 if wrap32 else _num_chunks(wide_chunk_bits(n)) + 1


def wide_sums_to_int64_tensor(sm: torch.Tensor) -> torch.Tensor:
    """Fold the (chunks+1, slots) wide-sum channels into exact int64 sums,
    on the tensor's device.

    Leading channels are per-slot sums of the value's uint32 bit chunks
    (width inferred from the channel count), the last channel counts
    negative values (each negative's uint32 image is its value + 2**32,
    so the signed total subtracts that bias back out).
    """
    sm = sm.to(torch.int64)
    chunks = sm.shape[0] - 1
    bits = {4: 8, 6: 6, 8: 4}[chunks]
    total = torch.zeros(sm.shape[1], dtype=torch.int64, device=sm.device)
    for k in range(chunks):
        total += sm[k] << (bits * k)
    return total - (sm[chunks] << 32)


def wide_sums_to_int64(sm: np.ndarray) -> np.ndarray:
    """``wide_sums_to_int64_tensor`` for a NumPy array."""
    return wide_sums_to_int64_tensor(torch.from_numpy(
        np.asarray(sm).astype(np.int64))).numpy()


def seg_agg_plain(gid: torch.Tensor, val: torch.Tensor, *, num_slots: int,
                  wrap32: bool = False):
    """Plain version: ``(count, sum, min, max)`` in the kernel's layout.

    Tuples outside ``[0, num_slots)`` go to an overflow slot that is cut
    off.  Counts by ``bincount``, sums by int64 ``index_add_`` (cast back
    to int32: exact per channel, wrapping under ``wrap32``), min and max
    by ``scatter_reduce_`` from the neutral elements.
    """
    n, dev = gid.shape[0], gid.device
    valid = (gid >= 0) & (gid < num_slots)
    slot = torch.where(valid, gid, num_slots).to(torch.int64)
    cnt = torch.bincount(slot, minlength=num_slots + 1)[:num_slots]

    def channel(x: torch.Tensor) -> torch.Tensor:
        acc = torch.zeros(num_slots + 1, dtype=torch.int64, device=dev)
        return acc.index_add_(0, slot, x.to(torch.int64))[:num_slots]

    if wrap32:
        s = channel(val)
        sm = (((s - INT32_MIN) & _MASK32) + INT32_MIN).to(torch.int32)
    else:
        bits = wide_chunk_bits(n)
        u = val.to(torch.int64) & _MASK32
        chans = [channel((u >> (bits * k)) & ((1 << bits) - 1))
                 for k in range(_num_chunks(bits))]
        chans.append(channel(val < 0))
        sm = torch.stack(chans).to(torch.int32)

    def extreme(fill: int, how: str) -> torch.Tensor:
        out = torch.full((num_slots + 1,), fill, dtype=torch.int32,
                         device=dev)
        return out.scatter_reduce_(0, slot, val, how,
                                   include_self=True)[:num_slots]

    return (cnt.to(torch.int32), sm, extreme(INT32_MAX, "amin"),
            extreme(INT32_MIN, "amax"))


def seg_agg(gid: torch.Tensor, val: torch.Tensor, *, num_slots: int,
            wrap32: bool = False):
    """Per-slot ``(count, sum, min, max)`` of ``val`` grouped by ``gid``.

    gid/val: (n,) int32.  count/min/max are (num_slots,) int32; sum is
    (chunks+1, num_slots) int32 wide channels, or (num_slots,) wrapping
    int32 under ``wrap32``.
    """
    if not 1 <= num_slots < 1 << 31:
        raise ValueError(f"num_slots must be in [1, 2^31): {num_slots}")
    if gid.shape != val.shape or gid.dim() != 1:
        raise ValueError(f"gid and val must be 1-D of one shape: "
                         f"{tuple(gid.shape)}, {tuple(val.shape)}")
    n = gid.shape[0]
    rows = sum_rows(n, wrap32)
    if gid.device != val.device:
        raise ValueError(f"gid on {gid.device}, val on {val.device}")
    dev = gid.device
    if dev.type == "cpu":
        return seg_agg_plain(gid, val, num_slots=num_slots, wrap32=wrap32)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for name, t in (("gid", gid), ("val", val)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    cnt = torch.empty(num_slots, dtype=torch.int32, device=dev)
    sm = torch.empty((rows, num_slots), dtype=torch.int32, device=dev)
    mn = torch.empty(num_slots, dtype=torch.int32, device=dev)
    mx = torch.empty(num_slots, dtype=torch.int32, device=dev)
    chunk_bits = 8 if wrap32 else wide_chunk_bits(n)
    launch(kernel("seg_agg", "seg_agg", *[PTR] * 6, I64, I32, I32, I32, PTR),
           dev, gid.data_ptr(), val.data_ptr(), cnt.data_ptr(),
           sm.data_ptr(), mn.data_ptr(), mx.data_ptr(), n, num_slots,
           int(wrap32), chunk_bits)
    return cnt, (sm[0] if wrap32 else sm), mn, mx
