"""Kernel F: the partitioned probe (steps p2/p3 over a radix layout).

Counterpart of ``repro/kernels/probe/probe.py``.  On CUDA tensors
``probe`` launches ``csrc/partitioned_probe.cu``; on CPU tensors it runs
``probe_plain``, the same function in plain PyTorch: the TPU kernel's
fixed-iteration binary search, batched over the rows.  There is no
fallback between the two.

Layout (built by ``ops.build_partitioned_table``):
  table_keys (P, K) int32: each row sorted as uint32, padded with INT_MAX
  table_rids (P, K) int32: the matching build rids, padded with -1
  probe_keys (P, M) int32: the partition's probe keys, padded with -1
Output:
  match_rid  (P, M) int32: the rid of the leftmost equal key, or -1
"""
from __future__ import annotations

import torch

from .._build import I64, PTR, kernel, launch

PAD_KEY = 2**31 - 1
_MASK32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 values reinterpreted as uint32, held in int64."""
    return x.to(torch.int64) & _MASK32


def probe_plain(table_keys: torch.Tensor, table_rids: torch.Tensor,
                probe_keys: torch.Tensor) -> torch.Tensor:
    """Plain version: ``K.bit_length() + 1`` rounds of a uint32 binary
    search per probe key, as in ``_probe_kernel``."""
    k = table_keys.shape[1]
    tk = _u32(table_keys)
    target = _u32(probe_keys)
    lo = torch.zeros_like(target)
    hi = torch.full_like(target, k)
    for _ in range(max(1, k.bit_length() + 1)):
        mid = (lo + hi) >> 1
        go = (torch.gather(tk, 1, mid.clamp(0, k - 1)) < target) & (lo < hi)
        lo, hi = torch.where(go, mid + 1, lo), torch.where(go | (lo >= hi),
                                                           hi, mid)
    pos = lo.clamp(0, k - 1)
    found = (torch.gather(table_keys, 1, pos) == probe_keys) & \
        (probe_keys >= 0)
    return torch.where(found, torch.gather(table_rids, 1, pos), -1) \
        .to(torch.int32)


def _check(table_keys, table_rids, probe_keys) -> None:
    if table_keys.dim() != 2 or probe_keys.dim() != 2:
        raise ValueError("table_keys and probe_keys must be 2-D")
    if table_rids.shape != table_keys.shape:
        raise ValueError(f"table_rids {tuple(table_rids.shape)} != "
                         f"table_keys {tuple(table_keys.shape)}")
    if probe_keys.shape[0] != table_keys.shape[0]:
        raise ValueError(f"probe_keys has {probe_keys.shape[0]} rows, the "
                         f"table {table_keys.shape[0]}")
    if table_keys.shape[1] < 1:
        raise ValueError("table rows must hold at least one key")
    devs = {t.device for t in (table_keys, table_rids, probe_keys)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def probe(table_keys: torch.Tensor, table_rids: torch.Tensor,
          probe_keys: torch.Tensor) -> torch.Tensor:
    """For each probe key, the rid of the leftmost equal key of its row.

    table_keys, table_rids: (P, K) int32; probe_keys: (P, M) int32.
    Returns (P, M) int32: the rid, or -1 where the row holds no equal key
    or the probe key is negative (a pad).
    """
    _check(table_keys, table_rids, probe_keys)
    dev = table_keys.device
    if dev.type == "cpu":
        return probe_plain(table_keys, table_rids, probe_keys)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for name, t in (("table_keys", table_keys), ("table_rids", table_rids),
                    ("probe_keys", probe_keys)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    (p, k), m = table_keys.shape, probe_keys.shape[1]
    out = torch.empty((p, m), dtype=torch.int32, device=dev)
    launch(kernel("partitioned_probe", "partitioned_probe", *[PTR] * 4,
                  I64, I64, I64, PTR),
           dev, table_keys.data_ptr(), table_rids.data_ptr(),
           probe_keys.data_ptr(), out.data_ptr(), p, k, m)
    return out


def max_shared_keys() -> int:
    """The longest row the kernel stages in shared memory on the current
    CUDA device; longer rows are searched in device memory."""
    return int(kernel("partitioned_probe",
                      "partitioned_probe_max_shared_keys",
                      returns=I64).fn())
