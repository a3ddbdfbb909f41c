"""Per-step unit-cost calibration (paper §4.2).

Counterpart of ``repro/core/calibrate.py``.  ``measure_unit_costs`` runs
each step's ``apply`` on a device group and times it, ending every timed
run with the group's ``synchronize`` (on a CUDA group that is
``torch.cuda.synchronize``; without it the clock would read only the
launch overhead).  ``APU_CPU``/``APU_GPU`` reproduce the paper's hardware
(Table 1) for model-only projections.  The JAX package's TPU constants do
not carry over: a ``DeviceSpec`` for the H100 comes from measurements on
the card.
"""
from __future__ import annotations

import time

import numpy as np

from .cost_model import DeviceSpec

# --- Paper Table 1: AMD A8-3870K APU (see repro/core/calibrate.py) ---------
APU_CPU = DeviceSpec("apu_cpu", ops_per_s=12e9, seq_bw_bytes_per_s=10e9,
                     rand_access_per_s=85e6)
APU_GPU = DeviceSpec("apu_gpu", ops_per_s=1200e9, seq_bw_bytes_per_s=40e9,
                     rand_access_per_s=120e6)


def _time_fn(fn, sync, *args, reps: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn(*args)
        sync()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def measure_unit_costs(series, shared, items, group, *,
                       reps: int = 5) -> dict[str, float]:
    """Measured seconds/item for each step of ``series`` on ``group``.

    Steps run in order, each on the previous step's real output, so
    workload-dependent steps see realistic inputs (paper §4.2).
    """
    out: dict[str, float] = {}
    n = next(iter(items.values())).shape[0]
    items_d = group.put_items(items)
    shared_d = {k: (v if isinstance(v, (int, float, str, bool))
                    else group.put_shared(v)) for k, v in shared.items()}
    for step in series.steps:
        def f(it, _apply=step.apply):
            return _apply(shared_d, it)
        dt = _time_fn(f, group.synchronize, items_d, reps=reps)
        out[step.name] = dt / max(n, 1)
        items_d, _ = f(items_d)
        if not items_d:  # terminal step (b4/p4) consumed the items
            break
    return out


def calibrated_overrides(series, shared, items, group_c, group_g,
                         **kw) -> dict[str, tuple[float, float]]:
    """(u_c, u_g) per step name: feed to series_model_from_costs."""
    uc = measure_unit_costs(series, shared, items, group_c, **kw)
    ug = measure_unit_costs(series, shared, items, group_g, **kw)
    return {k: (uc[k], ug[k]) for k in uc if k in ug}


class OnlineUnitCosts:
    """Closes the §4.2 calibration loop online, per phase (a copy of
    ``repro.core.calibrate.OnlineUnitCosts``, which is framework-free).

    Each served query's measured phase time against the model's estimate
    folds into a multiplicative scale on that phase's unit costs, as an
    EWMA in log space; ``version`` ticks when a scale moves materially.
    """

    def __init__(self, alpha: float = 0.5,
                 scale_bounds: tuple[float, float] = (1e-3, 1e3),
                 version_threshold: float = 1.2):
        self.alpha = float(alpha)
        self.scale_bounds = scale_bounds
        self.version = 0
        self.version_threshold = float(version_threshold)
        self._scale: dict[str, float] = {}
        self._samples: dict[str, int] = {}
        self._scale_at_tick: dict[str, float] = {}

    def scale_for(self, phase: str) -> float:
        return self._scale.get(phase, 1.0)

    def observe(self, phase: str, est_s: float, measured_s: float) -> float:
        """Fold one (estimate, measurement) pair in; returns the new scale.
        The first observation of a phase corrects fully, later ones smooth
        with ``alpha``; ``alpha == 0`` freezes the scales."""
        if est_s <= 0.0 or measured_s <= 0.0:
            return self.scale_for(phase)
        if self.alpha == 0.0:
            return self.scale_for(phase)
        ratio = min(max(measured_s / est_s, 1e-3), 1e3)
        a = 1.0 if self._samples.get(phase, 0) == 0 else self.alpha
        prev = self.scale_for(phase)
        s = prev * ratio ** a
        lo, hi = self.scale_bounds
        s = min(max(s, lo), hi)
        self._scale[phase] = s
        self._samples[phase] = self._samples.get(phase, 0) + 1
        anchor = self._scale_at_tick.get(phase, 1.0)
        if max(s, anchor) / max(min(s, anchor), 1e-30) > \
                self.version_threshold:
            self.version += 1
            self._scale_at_tick[phase] = s
        return s

    def to_dict(self) -> dict:
        return {p: {"scale": self._scale[p],
                    "samples": self._samples.get(p, 0)}
                for p in sorted(self._scale)}
