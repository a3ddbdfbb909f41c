"""The control of joins whose keys repeat: the equi-join worked out as if
the keys were unique on both sides, in plain PyTorch.

It keeps one pair per key that both relations hold: the first probe
tuple and the first build tuple with that key, in row order.  Where the
build keys are unique and the probe keys repeat (a primary key built, a
foreign key probed), it drops every repeat of a probe key, which
``bench.reference.join.first_match_pairs`` would keep; where the build
keys repeat, it drops their repeats too.  Codes as ``join_pairs``'s:
sorted int64 ``probe_rid << 32 | build_rid``.  Nothing of the program
under test is imported.
"""
from __future__ import annotations

import torch

I64 = torch.int64


def _first_of_each_key(rid: torch.Tensor, key: torch.Tensor):
    """The distinct keys, ascending, and the rid of each one's first
    tuple in row order."""
    skey, order = torch.sort(key, stable=True)
    uniq, counts = torch.unique_consecutive(skey, return_counts=True)
    first = torch.cumsum(counts, 0) - counts
    return uniq, rid[order[first]]


def unique_key_pairs(build_rid, build_key, probe_rid, probe_key
                     ) -> torch.Tensor:
    """Sorted int64 pair codes, one per key both sides hold."""
    bkey, brid = _first_of_each_key(build_rid, build_key)
    pkey, prid = _first_of_each_key(probe_rid, probe_key)
    at = torch.searchsorted(bkey, pkey).clamp_(max=max(bkey.shape[0] - 1, 0))
    both = (bkey[at] == pkey) if bkey.numel() else torch.zeros_like(
        pkey, dtype=torch.bool)
    codes = (prid[both].to(I64) << 32) | brid[at[both]].to(I64)
    return torch.sort(codes).values
