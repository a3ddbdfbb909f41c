"""Two-column ``(rid, key)`` relations made on a device from a seed.

The paper's relations (§5.1) are 4-byte row ids and 4-byte keys.  ``rid``
is the row number; the keys come from a ``torch.Generator`` on the target
device in one call, so one ``(seed, stream)`` gives the same bits on the
same device and nothing is drawn on the host.

A key spec is a dict from a configuration file:

* ``{"dist": "uniform", "range": R}``: keys uniform in ``[0, R)``;
* ``{"dist": "unique"}``: a permutation of ``[0, rows)``;
* ``{"dist": "zipf", "range": R, "s": s}``: key ranks Zipf-distributed
  with exponent ``s`` over ``R`` keys, the ranks mapped to keys by a
  seeded permutation so the hot keys are spread over the key space.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

INT32 = torch.int32


def stream_seed(seed: int, *stream) -> int:
    """A 63-bit generator seed for one named stream of a run.

    ``stream`` holds ints and strings (strings enter as their CRC-32), so
    every query, side and pool slot draws from its own stream of the run's
    seed, whatever thread makes it."""
    words = [int(seed) % (1 << 64)]
    for s in stream:
        words.append(zlib.crc32(s.encode()) if isinstance(s, str)
                     else int(s) % (1 << 64))
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(device, seed: int, *stream) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, *stream))
    return g


def make_keys(spec: dict, rows: int, device, seed: int, *stream
              ) -> torch.Tensor:
    """``rows`` int32 keys drawn as ``spec`` says, on ``device``."""
    g = generator(device, seed, *stream)
    dist = spec["dist"]
    if dist == "uniform":
        return torch.randint(0, int(spec["range"]), (rows,), generator=g,
                             device=device, dtype=INT32)
    if dist == "unique":
        return torch.randperm(rows, generator=g, device=device,
                              dtype=torch.int64).to(INT32)
    if dist == "zipf":
        rng = int(spec["range"])
        ranks = torch.arange(1, rng + 1, device=device, dtype=torch.float64)
        cdf = torch.cumsum(ranks.pow(-float(spec["s"])), 0)
        cdf /= cdf[-1].clone()
        u = torch.rand(rows, generator=g, device=device, dtype=torch.float64)
        rank = torch.searchsorted(cdf, u).clamp_(max=rng - 1)
        perm = torch.randperm(rng, generator=g, device=device,
                              dtype=torch.int64)
        return perm[rank].to(INT32)
    raise ValueError(f"unknown key distribution {dist!r}")


def make_relation(spec: dict, device, seed: int, *stream
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(rid, key)`` of ``spec["rows"]`` tuples: rid = row number."""
    rows = int(spec["rows"])
    rid = torch.arange(rows, dtype=INT32, device=device)
    return rid, make_keys(spec["keys"], rows, device, seed, *stream)
