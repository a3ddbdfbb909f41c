"""Plain PyTorch equi-join answer and its comparison, on any device.

The answer to ``R ⋈ S`` on ``key`` is the multiset of ``(probe rid,
build rid)`` pairs, one for each pair of tuples with equal keys.  It is
worked out here by sorting the build keys and two binary searches per
probe key, from the relations the benchmark made, and encoded as sorted
int64 codes ``probe_rid << 32 | build_rid`` (rids are non-negative
int32).  Nothing of the program under test is imported.

``first_match_pairs`` is the control: the same join keeping only the
first build match of each probe tuple, as a join that took the build keys
to be unique would.
"""
from __future__ import annotations

import torch

I64 = torch.int64


def _expand(build_rid, build_key, probe_rid, probe_key, *, first_only):
    bkey, order = torch.sort(build_key, stable=True)
    pk = probe_key.contiguous()
    lo = torch.searchsorted(bkey, pk, side="left")
    hi = torch.searchsorted(bkey, pk, side="right")
    counts = hi - lo
    if first_only:
        counts = counts.clamp(max=1)
    rows = torch.repeat_interleave(
        torch.arange(pk.shape[0], device=pk.device), counts)
    first = torch.cumsum(counts, 0) - counts
    within = torch.arange(rows.shape[0], device=pk.device) - first[rows]
    brow = order[lo[rows] + within]
    codes = (probe_rid[rows].to(I64) << 32) | build_rid[brow].to(I64)
    return torch.sort(codes).values


def join_pairs(build_rid, build_key, probe_rid, probe_key) -> torch.Tensor:
    """Sorted int64 pair codes of every match."""
    return _expand(build_rid, build_key, probe_rid, probe_key,
                   first_only=False)


def first_match_pairs(build_rid, build_key, probe_rid, probe_key
                      ) -> torch.Tensor:
    """The control: at most one (the first) build match per probe tuple."""
    return _expand(build_rid, build_key, probe_rid, probe_key,
                   first_only=True)


def pair_codes(probe_rid: torch.Tensor, build_rid: torch.Tensor
               ) -> torch.Tensor:
    """Sorted int64 codes of an answer's ``(probe rid, build rid)``."""
    codes = (probe_rid.to(I64) << 32) | build_rid.to(I64)
    return torch.sort(codes).values


def wrong_pairs(got: torch.Tensor, want: torch.Tensor) -> int:
    """Size of the multiset difference of two sorted code vectors, both
    ways: pairs missing from ``got``, pairs it has that ``want`` lacks,
    and pairs it repeats.  ``want`` holds each pair once."""
    want = want.to(got.device)
    uniq, counts = torch.unique_consecutive(got, return_counts=True)
    repeats = int((counts - 1).sum()) if counts.numel() else 0
    found = int(torch.isin(uniq, want).sum()) if uniq.numel() else 0
    return repeats + (uniq.shape[0] - found) + (want.shape[0] - found)
