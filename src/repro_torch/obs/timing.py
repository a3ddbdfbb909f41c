"""Device times of a function on a CUDA card, for ``chip_smoke.py`` and
the tools under ``tools/``.

* ``cuda_ms``: ``reps`` calls enqueued back to back between two CUDA
  events, so the host's per-call work overlaps the device's instead of
  adding to it (where the host takes longer per call than the device,
  it reads the host's time); the median of three such runs.
* ``graph_ms``: ``reps`` calls captured in one CUDA graph, its replay
  timed with CUDA events (the median of three): the device's time
  alone, even where the host's per-call work takes longer.
* ``call_ms``: each call timed alone with CUDA events, host waits
  inside it included; the median of ``reps``.

Each runs ``fn`` first to warm it up.  Nothing here runs at import time.
"""
from __future__ import annotations

import statistics

import torch


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn()``, back to back."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start, end = _events()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def graph_ms(fn, reps: int = 20) -> float:
    """Device milliseconds per call of ``fn()``, in a CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start, end = _events()
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def call_ms(fn, reps: int = 5) -> float:
    """Milliseconds of one call of ``fn()``, each timed alone."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = _events()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
