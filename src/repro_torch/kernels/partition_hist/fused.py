"""Kernel A: radix-partition steps n1+n2 fused (pid + histogram).

Counterpart of ``repro/kernels/partition_hist/fused.py``.  On a CUDA
tensor ``partition_hist_fused`` launches ``csrc/partition_hist_fused.cu``
at any ``n``; on a CPU tensor it runs ``partition_hist_fused_plain``, the
same function in plain PyTorch.  There is no fallback between the two.
"""
from __future__ import annotations

import torch

from .._build import I32, I64, PTR, kernel, launch
from .partition_hist import radix_hist_plain

MURMUR_C1 = 0x85EBCA6B
MURMUR_C2 = 0xC2B2AE35
_MASK32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2^32`` for int64 ``h`` in [0, 2^32), without overflow:
    the constant is split into 16-bit halves so no product passes 2^48."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def fmix32_int64(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3 fmix32 of int32 keys as uint32 values held in int64.

    Torch has no uint32 arithmetic and ``>>`` on int32 is arithmetic, so
    the hash runs in int64 masked to 32 bits: negative keys hash as their
    two's-complement bit pattern, as the JAX package's uint32 hash does.
    """
    h = x.to(torch.int64) & _MASK32
    h = h ^ (h >> 16)
    h = _mul32(h, MURMUR_C1)
    h = h ^ (h >> 13)
    h = _mul32(h, MURMUR_C2)
    return h ^ (h >> 16)


def partition_hist_fused_plain(keys: torch.Tensor, *, shift: int, bits: int):
    """Plain version: ``(pid, hist)`` for hash bits ``[shift, shift+bits)``.

    At ``bits = 32`` a pid with its top bit set is negative as int32 and,
    as in the JAX package's ``segment_sum``, is not counted."""
    pid = ((fmix32_int64(keys) >> shift) & ((1 << bits) - 1)).to(torch.int32)
    return pid, radix_hist_plain(pid, num_parts=1 << bits)


def _check(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor")


def partition_hist_fused(keys: torch.Tensor, *, shift: int, bits: int):
    """``(pid, hist)`` of the ``bits``-wide hash digit at ``shift``.

    keys: (n,) int32.  Returns pid (n,) int32 and hist (2**bits,) int32.
    Any digit the JAX package takes is accepted: ``1 <= bits`` and
    ``shift + bits <= 32``.
    """
    if bits < 1 or shift < 0 or shift + bits > 32:
        raise ValueError(f"need 1 <= bits and shift + bits <= 32: "
                         f"shift={shift}, bits={bits}")
    if keys.device.type == "cpu":
        return partition_hist_fused_plain(keys, shift=shift, bits=bits)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    _check("keys", keys)
    n = keys.shape[0]
    pid = torch.empty(n, dtype=torch.int32, device=keys.device)
    hist = torch.empty(1 << bits, dtype=torch.int32, device=keys.device)
    launch(kernel("partition_hist_fused", "partition_hist_fused", PTR, PTR,
                  PTR, I64, I32, I32, PTR),
           keys.device, keys.data_ptr(), pid.data_ptr(), hist.data_ptr(), n,
           shift, bits)
    return pid, hist
