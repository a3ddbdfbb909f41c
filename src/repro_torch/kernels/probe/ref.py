"""Plain PyTorch oracle for the partitioned probe kernel, and random
layouts to hold the kernel against it.

Counterpart of ``repro/kernels/probe/ref.py``: a batched
``torch.searchsorted`` over the rows plus a gather.  Keys compare as
uint32 (held in int64), so -1 probe pads and negative real keys sort after
the ``INT_MAX`` row pads, as in the JAX reference.
"""
import numpy as np
import torch

from .probe import PAD_KEY, _u32


def probe_ref(table_keys: torch.Tensor, table_rids: torch.Tensor,
              probe_keys: torch.Tensor) -> torch.Tensor:
    """Per-row sorted lookup: the first matching rid, or -1."""
    k = table_keys.shape[1]
    pos = torch.searchsorted(_u32(table_keys).contiguous(),
                             _u32(probe_keys).contiguous()).clamp(0, k - 1)
    found = (torch.gather(table_keys, 1, pos) == probe_keys) & \
        (probe_keys >= 0)
    return torch.where(found, torch.gather(table_rids, 1, pos), -1) \
        .to(torch.int32)


def random_layout(p: int, k: int, m: int, *, seed: int, device="cpu",
                  sorted_rows: bool = True):
    """A (P, K) table and (P, M) probe keys made from a NumPy seed: rows
    sorted as uint32 with duplicate build keys, negative real keys and
    INT_MAX pads at random fill; probe keys with misses, negative keys and
    -1 pads.  With ``sorted_rows=False`` each row's (key, rid) pairs are
    then permuted (the kernel must agree with the reference's search on
    any row).  Returns ``(table_keys, table_rids, probe_keys)``."""
    rng = np.random.default_rng(seed)
    span = max(4, k // 2)
    keys = rng.integers(-span // 4, span, (p, k)).astype(np.int32)
    fill = rng.integers(0, k + 1, (p, 1))
    keys[np.arange(k)[None, :] >= fill] = PAD_KEY
    tk = torch.from_numpy(keys).to(device)
    order = torch.sort(_u32(tk), dim=1, stable=True).indices
    tk = torch.gather(tk, 1, order).contiguous()
    tr = torch.from_numpy(rng.integers(0, 2**31 - 1, (p, k))
                          .astype(np.int32)).to(device)
    pk = rng.integers(-span // 4 - 2, span + 2, (p, m)).astype(np.int32)
    pk[rng.random((p, m)) < 0.125] = -1
    if not sorted_rows:
        perm = torch.from_numpy(np.argsort(rng.random((p, k)), axis=1)) \
            .to(device)
        tk = torch.gather(tk, 1, perm).contiguous()
        tr = torch.gather(tr, 1, perm).contiguous()
    return tk, tr, torch.from_numpy(pk).to(device)
