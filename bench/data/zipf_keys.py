"""Zipf-distributed int32 keys made on a device from a seed, bit for bit
the same on every call.

``bench.data.relations`` draws a ``zipf`` key's rank by a binary search of
``u`` in the float64 running sum of ``k^-s``.  On a CUDA card that sum is
a parallel scan whose additions are grouped by the order in which its
blocks finish, so its last bits, and the rank of a ``u`` that falls next
to a boundary, differ between calls: the relation a run joins and the one
its check remakes from the seed can differ in a tuple or two.  Here the
weights are integers, ``floor(scale * k^-s)``, and their running sum is
exact in any order, so one ``(seed, stream)`` gives the same keys on every
call; ``u`` is an integer drawn below the total.

The spec is the same: ``{"dist": "zipf", "range": R, "s": s}``, ranks
mapped to keys by a seeded permutation of ``[0, R)``.
"""
from __future__ import annotations

import math

import torch

from .relations import INT32, generator, make_relation

# The weights' total stays below 2^48: ``torch.randint`` reduces 64 random
# bits modulo the total, which favours some values by at most total / 2^64
# (here 2^-16), and the rarest weight at R = 2^24, s = 1 is still about
# 2^20, so flooring moves no probability by more than 2^-20 of itself.
TOTAL_MAX = 1 << 48


def _sum_bound(rng: int, s: float) -> float:
    """An upper bound of sum_{k=1..rng} k^-s (1 + the integral)."""
    if s == 1.0:
        return 1.0 + math.log(rng)
    return 1.0 + (rng ** (1.0 - s) - 1.0) / (1.0 - s)


def zipf_keys(spec: dict, rows: int, device, seed: int, *stream
              ) -> torch.Tensor:
    """``rows`` int32 keys of ``spec`` (``dist`` ``zipf``), ranks drawn with
    probability proportional to ``k^-s`` over ``range`` keys."""
    if spec["dist"] != "zipf":
        raise ValueError(f"not a zipf spec: {spec!r}")
    rng, s = int(spec["range"]), float(spec["s"])
    g = generator(device, seed, *stream)
    scale = math.floor(TOTAL_MAX / _sum_bound(rng, s))
    ranks = torch.arange(1, rng + 1, device=device, dtype=torch.float64)
    weight = torch.floor(ranks.pow_(-s).mul_(scale)).to(torch.int64)
    cdf = torch.cumsum(weight, 0)
    del weight
    u = torch.randint(0, int(cdf[-1]), (rows,), generator=g, device=device,
                      dtype=torch.int64)
    rank = torch.searchsorted(cdf, u, right=True)
    perm = torch.randperm(rng, generator=g, device=device, dtype=torch.int64)
    return perm[rank].to(INT32)


def make_relation_exact(spec: dict, device, seed: int, *stream
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """``bench.data.relations.make_relation``, with ``zipf`` keys from
    ``zipf_keys``."""
    if spec["keys"]["dist"] != "zipf":
        return make_relation(spec, device, seed, *stream)
    rows = int(spec["rows"])
    rid = torch.arange(rows, dtype=INT32, device=device)
    return rid, zipf_keys(spec["keys"], rows, device, seed, *stream)
