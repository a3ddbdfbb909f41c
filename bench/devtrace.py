"""The traced window as the card saw it, from ``torch.profiler``.

``DeviceTrace.from_profile`` keeps every kernel, copy and set on the card
inside the window (the ``bench.window`` annotation), with its time, in
seconds on the profiler's clock.  Idle gaps are named by the spans of the
program's tracer and the benchmark's own spans (on the host's
``perf_counter``), moved onto the profiler's clock by the window's start.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

from .intervals import covered, gaps
from .roofline import function_name

WINDOW = "bench.window"
# Spans looked back over for the one open at an idle gap.
SCAN_BACK = 4096


@dataclasses.dataclass
class DeviceTrace:
    window: tuple[float, float]
    ops: list[tuple[str, float, float]]        # (name, start, end) on card
    offset: float = 0.0        # host perf_counter minus profiler clock

    @classmethod
    def from_profile(cls, prof, window_start: float) -> "DeviceTrace":
        """``window_start``: ``perf_counter`` as the window opened."""
        ops, window = [], None
        for e in prof.events():
            a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if e.name == WINDOW and "CPU" in str(e.device_type):
                window = (a, b)
            elif "CUDA" in str(e.device_type):
                if not (e.is_user_annotation or e.name.startswith("bench.")):
                    ops.append((e.name, a, b))
        if window is None:
            raise RuntimeError(f"the profile holds no {WINDOW!r} annotation")
        return cls(window, ops, window_start - window[0])

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the card."""
        return covered(((a, b) for _, a, b in self.ops), *self.window)

    def kernels(self) -> list[tuple[str, float]]:
        """``(profiler name, seconds)`` of every operation in the window."""
        lo, hi = self.window
        return [(n, b - a) for n, a, b in self.ops if a >= lo and b <= hi]

    def device_ops(self, top: int = 10) -> list[list]:
        """The operations that took the most device time, by function."""
        by = defaultdict(float)
        for name, s in self.kernels():
            by[function_name(name)] += s
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])
                [:top]]

    def idle_gaps(self, spans, top: int = 10) -> list[list]:
        """Idle seconds of the card by what the host was doing: each gap
        goes to the innermost of ``spans`` (``(name, t0, t1)`` on the
        host's clock) open at its middle."""
        by = defaultdict(float)
        spans = sorted(spans, key=lambda h: h[1])
        starts = [h[1] for h in spans]
        for a, b in gaps(((x, y) for _, x, y in self.ops), *self.window):
            mid = (a + b) / 2 + self.offset
            label = "no span open"
            i = bisect.bisect_right(starts, mid)
            for name, x, y in reversed(spans[max(0, i - SCAN_BACK):i]):
                if y >= mid:
                    label = name
                    break
            by[label] += b - a
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])
                [:top]]
