"""Kernel D: murmur3 fmix32 bucket number (steps n1/b1/p1).

Counterpart of ``repro/kernels/hash/hash.py``.  On a CUDA tensor
``hash_bucket`` launches ``csrc/hash_bucket.cu`` at any ``n``; on a CPU
tensor it runs ``hash_bucket_plain``, the same function in plain PyTorch.
There is no fallback between the two.
"""
from __future__ import annotations

import torch

from .._build import I64, PTR, U32, kernel, launch
from ..partition_hist.fused import fmix32_int64

MAX_BUCKETS = 1 << 31  # the mask must fit the kernel's uint32 and int32 out


def hash_bucket_plain(keys: torch.Tensor, *, num_buckets: int) -> torch.Tensor:
    """Plain version: ``fmix32(key) & (num_buckets - 1)`` as int32."""
    return (fmix32_int64(keys) & (num_buckets - 1)).to(torch.int32)


def hash_bucket(keys: torch.Tensor, *, num_buckets: int) -> torch.Tensor:
    """Bucket id ``fmix32(key) & (num_buckets - 1)`` of every key.

    keys: (n,) int32; num_buckets a power of two in [1, 2^31].  Returns
    (n,) int32.
    """
    if (num_buckets < 1 or num_buckets & (num_buckets - 1)
            or num_buckets > MAX_BUCKETS):
        raise ValueError(f"num_buckets must be a power of two in "
                         f"[1, 2^31]: {num_buckets}")
    if keys.device.type == "cpu":
        return hash_bucket_plain(keys, num_buckets=num_buckets)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    if keys.dtype != torch.int32:
        raise TypeError(f"keys must be int32, got {keys.dtype}")
    if keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError("keys must be a contiguous 1-D tensor")
    n = keys.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=keys.device)
    launch(kernel("hash_bucket", "hash_bucket", PTR, PTR, I64, U32, PTR),
           keys.device, keys.data_ptr(), out.data_ptr(), n, num_buckets - 1)
    return out
