"""Kernel E: radix-partition step n2 on its own, the histogram of a pid
vector.

Counterpart of ``repro/kernels/partition_hist/partition_hist.py``.  On a
CUDA tensor ``radix_hist`` launches ``csrc/radix_hist.cu`` at any ``n``;
on a CPU tensor it runs ``radix_hist_plain``, the same function in plain
PyTorch.  Both drop pids outside ``[0, num_parts)``, as the TPU kernel's
one-hot and the JAX package's ``segment_sum`` do.
"""
from __future__ import annotations

import torch

from .._build import I64, PTR, kernel, launch


def radix_hist_plain(pid: torch.Tensor, *, num_parts: int) -> torch.Tensor:
    """Plain version: (num_parts,) int32 counts; out-of-range pids go to
    an overflow bin that is cut off."""
    valid = (pid >= 0) & (pid < num_parts)
    spill = torch.where(valid, pid, num_parts).to(torch.int64)
    counts = torch.bincount(spill, minlength=num_parts + 1)
    return counts[:num_parts].to(torch.int32)


@torch.library.custom_op("repro_torch::radix_hist", mutates_args=())
def radix_hist_op(pid: torch.Tensor, num_parts: int) -> torch.Tensor:
    """``radix_hist`` as a custom op, whose fake kernel gives the
    (num_parts,) int32 output for a trace under ``FakeTensorMode`` (the
    plain version's ``bincount`` has a data-dependent shape there)."""
    return radix_hist(pid, num_parts=num_parts)


@radix_hist_op.register_fake
def _(pid, num_parts):
    return pid.new_empty((num_parts,), dtype=torch.int32)


def radix_hist(pid: torch.Tensor, *, num_parts: int) -> torch.Tensor:
    """Histogram of ``pid`` over ``num_parts`` bins.

    pid: (n,) int32; num_parts >= 1.  Returns (num_parts,) int32; pids
    outside ``[0, num_parts)`` are not counted.
    """
    if num_parts < 1:
        raise ValueError(f"num_parts must be at least 1: {num_parts}")
    if pid.device.type == "cpu":
        return radix_hist_plain(pid, num_parts=num_parts)
    if pid.device.type != "cuda":
        raise ValueError(f"unsupported device {pid.device}")
    if pid.dtype != torch.int32:
        raise TypeError(f"pid must be int32, got {pid.dtype}")
    if pid.dim() != 1 or not pid.is_contiguous():
        raise ValueError("pid must be a contiguous 1-D tensor")
    hist = torch.empty(num_parts, dtype=torch.int32, device=pid.device)
    launch(kernel("radix_hist", "radix_hist", PTR, PTR, I64, I64, PTR),
           pid.device, pid.data_ptr(), hist.data_ptr(), pid.shape[0],
           num_parts)
    return hist
