"""Workload-divergence grouping (paper §3.3).

Counterpart of ``repro/core/divergence.py``.  All lanes of a warp (≙ an
OpenCL wavefront) retire together, so a tile whose items carry very
different work (skewed key lists) runs at the worst lane's speed.  The
paper groups input items by workload so each work group has uniform
work: sort probe tuples by their bucket's key count (known after p2)
before running p3/p4, and restore the original order afterwards.  The
number of groups (= sort granularity) trades grouping overhead against
divergence reduction; it is exposed as quantized sort keys.  Everything
runs on the device that holds ``workload``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def divergence_order(workload: torch.Tensor,
                     num_groups: int = 64) -> torch.Tensor:
    """Permutation grouping items of similar workload (stable within group).

    ``workload`` — per-item work estimate (e.g. kcount from p2).
    ``num_groups`` — quantization of the sort key (paper: "the number of
    groups is tuned for the tradeoff between the grouping overhead and the
    gain of reduced workload divergence").
    """
    if num_groups <= 1:
        return torch.arange(workload.shape[0], dtype=torch.int32,
                            device=workload.device)
    wmax = torch.clamp(workload.max(), min=1)
    g = ((workload * num_groups) // (wmax + 1)).clamp(
        max=num_groups - 1).to(torch.int32)
    return torch.argsort(g, stable=True).to(torch.int32)


def inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    inv = torch.zeros_like(order)
    inv[order.long()] = torch.arange(order.shape[0], dtype=order.dtype,
                                     device=order.device)
    return inv


def tile_divergence_waste(workload: torch.Tensor,
                          tile: int = 256) -> torch.Tensor:
    """Fraction of lane-cycles wasted to divergence at a given tile size.

    waste = 1 - sum(w) / sum(tile * max_per_tile), in float32.  The
    benchmark for the paper's 5–10% claim evaluates this metric
    before/after grouping.
    """
    n = workload.shape[0]
    pad = (-n) % tile
    w = F.pad(workload.to(torch.float32), (0, pad)).reshape(-1, tile)
    per_tile_cost = w.amax(dim=1) * tile
    total_cost = torch.clamp(per_tile_cost.sum(), min=1e-9)
    return 1.0 - w.sum() / total_cost
