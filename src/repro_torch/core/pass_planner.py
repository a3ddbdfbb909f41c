"""Cost-model-guided radix pass planner (paper §3.1's tuning knob).

A copy of ``repro/core/pass_planner.py`` (NumPy only); calibration runs
on a port ``DeviceGroup``.  One addition: ``u_g``, the G group's measured
n1-n3 costs.  The reference's groups are two slices of one backend, so it
prices G's share of a pass at C's costs; the port's G group is the card,
up to three orders of magnitude faster per item than the host.

The paper tunes the partition phase's two knobs — radix bits per pass and
number of passes — "according to the memory hierarchy".  The seed hard-coded
them at every call site; this module chooses them from the same machinery
the co-processing schemes already use: per-step unit costs (analytic
``DeviceSpec`` seeds or measurements from ``calibrate``) priced through
``SeriesCostModel``.

Model: one pass over ``n`` tuples with a ``b``-bit digit runs the series
(n1, n2, n3) where n1/n2 are fanout-independent but n3's random scatter
degrades once the ``2**b`` open partition streams exceed what the memory
hierarchy tracks (TLB entries / cache sets on the paper's APU, VMEM-resident
offset state on TPU).  We price that as a multiplicative penalty on n3's
random-access unit cost above a calibrated ``capacity_bits`` knee:

    u_n3(b) = u_n3 * (1 + penalty * max(0, b - capacity_bits))

A plan for ``total_bits`` is a schedule ``(b_1, .., b_p)`` with
``sum b_i = total_bits``; the planner enumerates pass counts, splits the
bits as evenly as possible (the paper's equal-width passes), sums per-pass
series costs, and returns the argmin.  With a small fanout (or a flat
hierarchy) one wide pass wins — fewer passes means fewer full relation
rewrites; with a large fanout the penalty pushes the plan to multiple
narrow passes, reproducing the paper's multi-pass regime.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .cost_model import (DeviceSpec, LinkSpec, ZEROCOPY_LINK,
                         series_model_from_costs)

# Average tuples per final partition the planner targets: small enough that
# a partition pair's working set stays cache/VMEM-resident for the join
# phase (the probe kernel's per-partition table), large enough to amortize
# headers.
DEFAULT_PART_TUPLES = 2048
# Fanout knee and per-extra-bit penalty; overridable from calibration.
DEFAULT_CAPACITY_BITS = 8
DEFAULT_FANOUT_PENALTY = 0.6
MAX_TOTAL_BITS = 16


@dataclasses.dataclass(frozen=True)
class PassPlan:
    """A chosen radix partitioning schedule (low digit first)."""

    schedule: tuple[int, ...]
    est_s: float

    @property
    def total_bits(self) -> int:
        return sum(self.schedule)

    @property
    def num_passes(self) -> int:
        return len(self.schedule)

    @property
    def bits_per_pass(self) -> int:
        """Widest pass — the knob the paper sweeps."""
        return max(self.schedule)


def even_schedule(total_bits: int, num_passes: int) -> tuple[int, ...]:
    """``total_bits`` split into ``num_passes`` near-equal digits."""
    base, rem = divmod(total_bits, num_passes)
    return tuple(base + 1 if i < rem else base for i in range(num_passes))


class PassPlanner:
    """Chooses ``bits_per_pass``/``num_passes`` from calibrated unit costs.

    ``u_n1``/``u_n2``/``u_n3`` are seconds/item at fanout 1; they come from
    a ``DeviceSpec`` (analytic) or from ``calibrate_partition_unit_costs``
    (measured).  ``capacity_bits``/``fanout_penalty`` encode the memory
    hierarchy's scatter knee.
    """

    def __init__(self, u_n1: float, u_n2: float, u_n3: float, *,
                 capacity_bits: int = DEFAULT_CAPACITY_BITS,
                 fanout_penalty: float = DEFAULT_FANOUT_PENALTY,
                 part_tuples: int = DEFAULT_PART_TUPLES,
                 u_g: dict[str, float] | None = None):
        self.u_n1 = float(u_n1)
        self.u_n2 = float(u_n2)
        self.u_n3 = float(u_n3)
        # Measured n1-n3 seconds/item on the G group; None mirrors C.
        self.u_g = ({k: float(u_g[k]) for k in ("n1", "n2", "n3")}
                    if u_g is not None else None)
        self.capacity_bits = int(capacity_bits)
        self.fanout_penalty = float(fanout_penalty)
        self.part_tuples = int(part_tuples)

    # -- construction --------------------------------------------------------
    @classmethod
    def from_device_spec(cls, spec: DeviceSpec, **kw) -> "PassPlanner":
        from .phj import PARTITION_COSTS
        return cls(spec.unit_cost(PARTITION_COSTS["n1"]),
                   spec.unit_cost(PARTITION_COSTS["n2"]),
                   spec.unit_cost(PARTITION_COSTS["n3"]), **kw)

    @classmethod
    def from_measurements(cls, unit_costs: dict[str, float], **kw
                          ) -> "PassPlanner":
        """From ``calibrate.measure_unit_costs`` output for one pass (on
        the C group; ``u_g=`` the same for the G group)."""
        return cls(unit_costs["n1"], unit_costs["n2"], unit_costs["n3"],
                   **kw)

    # -- the model -----------------------------------------------------------
    def scatter_factor(self, bits: int) -> float:
        return 1.0 + self.fanout_penalty * max(0, bits - self.capacity_bits)

    def pass_cost(self, n: int, bits: int) -> float:
        """Modeled seconds for one ``bits``-wide pass over ``n`` tuples,
        priced through the co-processing cost model (single-group run)."""
        return float(self.pass_model(n, bits).estimate_batch(
            np.ones((1, 3)))[0])

    def pass_model(self, n: int, bits: int, *,
                   device_g: DeviceSpec | None = None,
                   link: LinkSpec = ZEROCOPY_LINK):
        """A ``SeriesCostModel`` for one pass (n1, n2, n3) at this fanout.

        The C-group runs at this planner's calibrated unit costs with n3
        scaled by the fanout penalty; schemes can re-optimize ratios over
        it (``optimize_pl``/``optimize_dd``) exactly as for SHJ series.
        The G group runs at ``device_g``'s analytic costs when given, else
        at the measured ``u_g``, else at C's.
        """
        from .phj import PARTITION_COSTS, partition_series
        series = partition_series(0)
        fac = self.scatter_factor(bits)
        u_c = {"n1": self.u_n1, "n2": self.u_n2, "n3": self.u_n3 * fac}
        dev_c = DeviceSpec("planner_c", 1.0, 1.0, 1.0)
        dev_g = device_g or dev_c
        if device_g is not None:
            u_g = {nm: device_g.unit_cost(PARTITION_COSTS[nm]) for nm in u_c}
            u_g["n3"] *= fac
        elif self.u_g is not None:
            u_g = dict(self.u_g)
            u_g["n3"] *= fac
        else:
            u_g = dict(u_c)  # single-group planner: G mirrors C
        overrides = {nm: (u_c[nm], u_g[nm]) for nm in u_c}
        return series_model_from_costs(series.steps, [n] * 3, dev_c, dev_g,
                                       link, u_overrides=overrides)

    def schedule_cost(self, n: int, schedule: tuple[int, ...]) -> float:
        return sum(self.pass_cost(n, b) for b in schedule)

    # -- planning ------------------------------------------------------------
    def choose_total_bits(self, n: int) -> int:
        """Radix width so the average final partition holds
        ``part_tuples`` tuples (clamped to a sane range)."""
        want = max(1, round(math.log2(max(2, n / self.part_tuples))))
        return min(MAX_TOTAL_BITS, want)

    def plan(self, n: int, total_bits: int | None = None) -> PassPlan:
        """Best schedule for an ``n``-tuple relation (ties -> fewer
        passes: each extra pass is a full relation rewrite)."""
        total_bits = total_bits or self.choose_total_bits(n)
        best: PassPlan | None = None
        for p in range(1, total_bits + 1):
            sched = even_schedule(total_bits, p)
            est = self.schedule_cost(n, sched)
            if best is None or est < best.est_s - 1e-18:
                best = PassPlan(sched, est)
        return best


def calibrate_partition_unit_costs(group, n: int = 65536, *, bits: int = 6,
                                   reps: int = 3) -> dict[str, float]:
    """Measured n1/n2/n3 seconds/item on a device group (paper §4.2)."""
    from .calibrate import measure_unit_costs
    from .phj import partition_series
    from .relation import uniform_relation
    rel = uniform_relation(n, seed=0, device=group.device)
    return measure_unit_costs(partition_series(0),
                              {"shift": 0, "bits": bits},
                              {"rid": rel.rid, "key": rel.key}, group,
                              reps=reps)


def default_planner(device: DeviceSpec | None = None, **kw) -> PassPlanner:
    """Analytic planner for this host (APU CPU seeds when unspecified)."""
    if device is None:
        from .calibrate import APU_CPU
        device = APU_CPU
    return PassPlanner.from_device_spec(device, **kw)
