"""Interval arithmetic for spans and device activity (seconds)."""
from __future__ import annotations


def merged(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(intervals, lo: float = float("-inf"),
            hi: float = float("inf")) -> float:
    """Length of the union of ``intervals`` inside ``[lo, hi]``."""
    return sum(max(0.0, min(b, hi) - max(a, lo))
               for a, b in merged(intervals))


def gaps(busy, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of ``[lo, hi]`` that no interval of ``busy`` covers."""
    out, at = [], lo
    for a, b in merged(busy):
        if b <= lo or a >= hi:
            continue
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
    if at < hi:
        out.append((at, hi))
    return out
