"""Per-query scheme + algorithm planning (the paper's §3.2/§4 machinery,
promoted from hand-set benchmark knobs to an online decision per query).

For every admitted join the planner prices, through ``SeriesCostModel``:

  * SHJ under each co-processing scheme (CPU_ONLY / GPU_ONLY / OL / DD /
    PL), build and probe series separately — Eqs. 1–5 with the δ-sweep
    optimizers choosing the per-step ratios;
  * PHJ: planner-chosen radix schedule priced per pass (the
    ``PassPlanner`` knee model), plus a post-partition join phase whose
    random accesses are cache-resident (the paper's locality argument for
    partitioning in the first place).

SHJ's probe-side random accesses degrade once the hash table outgrows the
cache (working set ≈ 32 B/tuple of CSR arrays); that is priced as a
multiplicative penalty per doubling past ``cache_bytes`` — the same knee
idiom the pass planner uses for scatter fanout.  Small inputs therefore
plan to SHJ (partitioning is pure overhead) and large ones to PHJ,
reproducing the paper's regime split.

Two signals close the loop as traffic flows:

  * ``OnlineUnitCosts`` (calibrate.py) — measured phase times fold back
    into per-phase unit-cost scales, so estimates track this host;
  * cache awareness — a query whose build table is already resident is
    priced with zero build cost, which is what makes the engine prefer
    probe-only SHJ on hot tables over re-partitioning.

Counterpart of ``repro/engine/planner.py``: the same float64 arithmetic,
so the same inputs give the same plans.  The analytic defaults
(``cache_bytes``, ``rand_penalty``, ``handoff_*``, ``APU_CPU``/``APU_GPU``)
are model constants kept as the reference's; ``calibrated`` measures the
card and the host instead.  Where the reference keeps plans sticky to
reuse compiled executables, here stickiness keeps plans, ratios and
slice shapes stable across calibration wiggles (the CUDA kernels are
built once per process, not per shape).
"""
from __future__ import annotations

import dataclasses
import math
import threading

import numpy as np

from ..core.calibrate import APU_CPU, APU_GPU, OnlineUnitCosts
from ..core.cost_model import DeviceSpec, LinkSpec, SeriesCostModel
from ..core.hash_table import default_num_buckets
from ..core.pass_planner import PassPlanner, default_planner
from ..core.phj import default_shj_bits
from ..core.shj import BUILD_SERIES, PROBE_SERIES

SCHEMES = ("CPU_ONLY", "GPU_ONLY", "OL", "DD", "PL")
# What CoProcessor.build_table/probe_table actually realize: one quantized
# cut per phase (ratios[0]).  Per-step OL/PL vectors are priced by the
# model but only run_map_series executes them, and the engine does not use
# that path yet — so by default the planner only offers schemes whose
# estimate matches what will execute.  Pass allowed_schemes=SCHEMES to
# price the full catalog (model studies, paper figures).
EXECUTABLE_SCHEMES = ("CPU_ONLY", "GPU_ONLY", "DD")

# What a PL boundary exchange actually costs between host device groups: a
# device-to-host + concat + host-to-device round trip (~ms), not a zero-copy
# alias.  The analytic ZEROCOPY_LINK underprices that by orders of
# magnitude, which would make the planner pick PL ratio boundaries that
# measure slower than DD; this spec is calibrated to the observed host
# shuffle cost.  Pass an explicit link (ICI_LINK etc.) for pod-scale
# planning.
HOST_SHUFFLE_LINK = LinkSpec("host_shuffle", 1e-3, 1e9)

# CSR hash-table working set per build tuple (7 dense int32 columns plus
# bucket headers at the default load factor).
TABLE_BYTES_PER_TUPLE = 32


@dataclasses.dataclass
class QueryPlan:
    """Everything the executor needs, plus the estimates behind the choice."""

    algorithm: str                  # "shj" | "phj" | "groupby"
    scheme: str                     # one of SCHEMES
    build_ratios: tuple             # len-4 per-step CPU shares
    probe_ratios: tuple
    num_buckets: int
    max_out: int
    table_mode: str = "shared"
    cached: bool = False            # probe-only against a resident table
    est_s: float = 0.0
    est_build_s: float = 0.0        # phj: partition-phase estimate
    est_probe_s: float = 0.0        # phj: join-phase estimate
    # phj-only knobs (planner-chosen); groupby reuses schedule +
    # partition_ratio and carries its aggregate-phase split in join_ratio.
    schedule: tuple | None = None
    shj_bits: int = 0
    partition_ratio: float = 0.5
    join_ratio: float = 0.5
    # Join-variant semantics ("inner" | "semi" | "anti" | "left_outer"):
    # semi/anti probes skip the p4 payload gather, so they are priced on
    # the p1–p3 series only.
    kind: str = "inner"

    @property
    def c_share(self) -> float:
        """Mean CPU-side ratio — drives load-aware admission."""
        if self.algorithm in ("phj", "groupby"):
            return 0.5 * (self.partition_ratio + self.join_ratio)
        rs = list(self.probe_ratios) + ([] if self.cached
                                        else list(self.build_ratios))
        return float(np.mean(rs)) if rs else 0.5


def _unit_parts(device: DeviceSpec, cost) -> tuple[float, float]:
    """(non-random, random-access) components of seconds/item (Eq. 3)."""
    non_rand = (cost.ops_per_item / device.ops_per_s
                + cost.seq_bytes_per_item / device.seq_bw_bytes_per_s)
    rand = cost.rand_accesses_per_item / device.rand_access_per_s
    return non_rand, rand


class QueryPlanner:
    """Chooses algorithm, scheme, and ratios for one join query."""

    def __init__(self, device_c: DeviceSpec = APU_CPU,
                 device_g: DeviceSpec = APU_GPU,
                 link: LinkSpec = HOST_SHUFFLE_LINK, *,
                 discrete: bool = False,
                 delta: float = 0.05,
                 allowed_schemes: tuple[str, ...] = EXECUTABLE_SCHEMES,
                 allow_phj: bool = True,
                 cache_bytes: int = 4 << 20, rand_penalty: float = 0.35,
                 reuse_discount: float = 0.5,
                 phj_overhead_s: float = 2e-3,
                 coproc_margin: float = 1.1,
                 min_feedback_items: int = 2048,
                 replan_margin: float = 0.8,
                 handoff_latency_s: float = 2e-4,
                 handoff_bw_bytes_per_s: float = 2e9,
                 u_overrides: dict | None = None,
                 pass_planner: PassPlanner | None = None,
                 partition_device_g: DeviceSpec | None = None,
                 online: OnlineUnitCosts | None = None):
        self.device_c = device_c
        self.device_g = device_g
        self.link = link
        self.discrete = discrete
        self.delta = float(delta)
        self.allowed_schemes = tuple(allowed_schemes)
        self.allow_phj = allow_phj
        self.cache_bytes = int(cache_bytes)
        self.rand_penalty = float(rand_penalty)
        self.reuse_discount = float(reuse_discount)
        # Fixed per-query cost of PHJ's partition-ownership exchange (host
        # gather/scatter of both relations between the groups) — it is what
        # makes PHJ a losing plan for small queries even before the online
        # scales converge.
        self.phj_overhead_s = float(phj_overhead_s)
        # Handicap on mixed-ratio schemes (OL/DD/PL): splitting a step
        # series across groups carries coordination overhead the series
        # model does not price, so co-processing must promise at least
        # this factor of improvement over the best single-group plan.
        self.coproc_margin = float(coproc_margin)
        # Feedback floor: a query this small measures dispatch overhead,
        # not per-item cost — one such sample can swing the online scales
        # by orders of magnitude, and every material move invalidates all
        # sticky plans (replan churn).  The query pipeline's post-filter
        # stages routinely run a few hundred tuples; they must not
        # calibrate the model.
        self.min_feedback_items = int(min_feedback_items)
        # Replan hysteresis: when a calibration tick re-prices a sticky
        # signature, the challenger must beat the incumbent's re-priced
        # estimate by this factor to displace it.  Near-tie flips would
        # trade a warm plan (its cached state and calibrated scales) for
        # a fresh one each time the scales wiggle.
        self.replan_margin = float(replan_margin)
        # Host hand-off pricing: what one D2H gather + H2D re-upload of a
        # stage intermediate costs (latency + bytes/bandwidth).  Measured
        # on the real devices by ``calibrated``; the analytic defaults are
        # host-platform ballparks.  The join-order optimizer adds this
        # term per host-materialized stage hand-off and ~0 for the fused
        # device-resident hand-off, which is what lets it prefer orders
        # keeping the large intermediate resident.
        self.handoff_latency_s = float(handoff_latency_s)
        self.handoff_bw_bytes_per_s = float(handoff_bw_bytes_per_s)
        self.u_overrides = dict(u_overrides or {})
        self.pass_planner = pass_planner or default_planner(device_c)
        # None -> the G-group runs at the pass planner's measured G costs
        # (``calibrated``), else mirrors its C costs; a DeviceSpec prices
        # it analytically.  Analytic planners default to the G device
        # spec.
        self.partition_device_g = (partition_device_g if pass_planner
                                   is not None else
                                   (partition_device_g or device_g))
        self.online = online or OnlineUnitCosts()
        self.plan_counts: dict[tuple[str, str], int] = {}
        self._sweep_cache: dict = {}
        self._plan_cache: dict = {}
        self._replan_flags = 0
        self._lock = threading.Lock()

    # -- measured construction (paper §4.2, once at service start) ---------
    @classmethod
    def calibrated(cls, cp, *, n: int = 32768, reps: int = 2, **kw
                   ) -> "QueryPlanner":
        """Measure per-step unit costs on ``cp``'s real device groups.

        The relations are made on the host; each group's measurement moves
        them to its device, and every timed run ends in the group's
        ``synchronize``.  At the default ``n`` a step on the card takes
        about a launch, so its unit cost reads launch latency per item.

        Unlike the reference, whose two groups are slices of one backend
        (it prices G's partition passes at C's measured costs), the port
        measures the partition passes on both groups: here G is the card.
        """
        from ..core import build_hash_table, uniform_relation
        from ..core.calibrate import calibrated_overrides
        from ..core.pass_planner import calibrate_partition_unit_costs
        rel = uniform_relation(n, seed=0, device="cpu")
        probe = uniform_relation(n, key_range=n, seed=1, device="cpu")
        nb = default_num_buckets(n)
        items_b = {"rid": rel.rid, "key": rel.key}
        u = calibrated_overrides(BUILD_SERIES, {"num_buckets": nb}, items_b,
                                 cp.c, cp.g, reps=reps)
        table = build_hash_table(rel, nb)
        u.update(calibrated_overrides(
            PROBE_SERIES, {"table": table, "max_out": 4 * n,
                           "num_buckets": nb},
            {"rid": probe.rid, "key": probe.key}, cp.c, cp.g, reps=reps))
        part_u = calibrate_partition_unit_costs(cp.c, n, reps=reps)
        part_g = calibrate_partition_unit_costs(cp.g, n, reps=reps)
        lat, bw = cls._measure_handoff(cp)
        kw.setdefault("handoff_latency_s", lat)
        kw.setdefault("handoff_bw_bytes_per_s", bw)
        return cls(u_overrides=u,
                   pass_planner=PassPlanner.from_measurements(part_u,
                                                              u_g=part_g),
                   partition_device_g=None, **kw)

    @staticmethod
    def _measure_handoff(cp, reps: int = 3) -> tuple[float, float]:
        """Measured H2D/D2H unit cost of a host stage hand-off.

        Times an upload to the G group (``.to``, then the group's
        ``synchronize``) and the pull back (``.cpu()``) at two sizes: the
        small buffer isolates the per-transfer latency, the large one the
        bandwidth (both directions count — a host hand-off pays a gather
        down and an upload back).  The buffers are pageable host memory,
        so the bandwidth read here is that of staged copies, which is
        what the service's own ``.cpu()`` pulls pay, not the bus's pinned
        rate.
        """
        import time as _time

        import torch as _torch

        def round_trip(n):
            buf = _torch.zeros(n, dtype=_torch.int32)
            ts = []
            for _ in range(reps + 1):   # first rep warms allocation paths
                t0 = _time.perf_counter()
                dev = buf.to(cp.g.device)
                cp.g.synchronize()
                dev.cpu()
                ts.append(_time.perf_counter() - t0)
            return float(np.median(ts[1:]))

        small, large = 256, 1 << 18                    # 1 KiB vs 1 MiB
        t_small = round_trip(small)
        t_large = round_trip(large)
        lat = max(1e-6, t_small)
        bw = (2 * 4 * (large - small)) / max(t_large - t_small, 1e-9)
        return lat, max(bw, 1e8)

    def host_handoff_s(self, nbytes: int) -> float:
        """Cost of one host-materialized stage hand-off of ``nbytes``."""
        if nbytes <= 0:
            return 0.0
        return self.handoff_latency_s + nbytes / self.handoff_bw_bytes_per_s

    # -- model construction --------------------------------------------------
    def table_rand_scale(self, build_n: int) -> float:
        """Random-access penalty once the table outgrows the cache."""
        ws = max(1, build_n * TABLE_BYTES_PER_TUPLE)
        excess = max(0.0, math.log2(ws / self.cache_bytes))
        return 1.0 + self.rand_penalty * excess

    def _series_model(self, series, x, *, rand_scale: float = 1.0
                      ) -> SeriesCostModel:
        names, u_c, u_g, outb = [], [], [], []
        for s in series:
            nc, rc = _unit_parts(self.device_c, s.cost)
            ng, rg = _unit_parts(self.device_g, s.cost)
            if s.name in self.u_overrides:
                # Measured u; the rand share of the *analytic* split decides
                # how much of it the table-size penalty inflates.
                mc, mg = self.u_overrides[s.name]
                fc = rc / max(nc + rc, 1e-30)
                fg = rg / max(ng + rg, 1e-30)
                uc = mc * (1.0 + fc * (rand_scale - 1.0))
                ug = mg * (1.0 + fg * (rand_scale - 1.0))
            else:
                uc = nc + rc * rand_scale
                ug = ng + rg * rand_scale
            names.append(s.name)
            u_c.append(uc)
            u_g.append(ug)
            outb.append(s.cost.out_bytes_per_item)
        return SeriesCostModel(names, u_c, u_g, np.asarray(x, np.float64),
                               np.asarray(outb, np.float64), self.link,
                               discrete=self.discrete)

    def _sweep(self, key, series, x, *, rand_scale: float):
        """Memoized scheme sweep (hot-table traffic re-plans same shapes).

        The sweep prices the *unscaled* model, so the chosen ratios — and
        therefore the slice shapes — are stable; online scales
        adjust candidate totals afterwards, per scheme.
        """
        cache_key = (key, tuple(x), round(rand_scale, 4), self.delta)
        with self._lock:
            hit = self._sweep_cache.get(cache_key)
        if hit is not None:
            return hit
        m = self._series_model(series, x, rand_scale=rand_scale)
        out = m.scheme_sweep(delta=self.delta, schemes=self.allowed_schemes)
        with self._lock:
            if len(self._sweep_cache) > 512:
                self._sweep_cache.clear()
            self._sweep_cache[cache_key] = out
        return out

    # -- candidate estimates -------------------------------------------------
    def _shj_candidates(self, build_n: int, probe_n: int, cached: bool,
                        kind: str = "inner"):
        rs = self.table_rand_scale(build_n)
        # Semi/anti emit match flags instead of expanding matches: the p4
        # payload gather (2 random accesses/tuple) drops out of the series,
        # which is what makes those probes cheaper than inner at equal
        # sizes.  Left-outer keeps the full expansion (plus the unmatched
        # emission riding the same scan).
        probe_steps = (PROBE_SERIES.steps[:3] if kind in ("semi", "anti")
                       else PROBE_SERIES.steps)
        probe_tag = ("shj_probe" if kind == "inner"
                     else f"shj_probe[{kind}]")
        probe = self._sweep(probe_tag, probe_steps,
                            [probe_n] * len(probe_steps), rand_scale=rs)
        if cached:
            build = None
        else:
            build = self._sweep("shj_build", BUILD_SERIES.steps,
                                [build_n] * 4, rand_scale=rs)
        for scheme in self.allowed_schemes:
            rp, tp = probe[scheme]
            rb, tb = build[scheme] if build else (rp, 0.0)
            # Per-scheme online scales: a PL plan's boundary shuffles and a
            # DD plan's flat split calibrate independently.
            tp = tp * self.online.scale_for(f"{probe_tag}:{scheme}")
            tb = tb * self.online.scale_for(f"shj_build:{scheme}")
            yield QueryPlan(
                algorithm="shj", scheme=scheme,
                build_ratios=tuple(float(r) for r in rb),
                probe_ratios=tuple(float(r) for r in rp),
                num_buckets=default_num_buckets(build_n), max_out=0,
                cached=cached, est_s=tb + tp, est_build_s=tb,
                est_probe_s=tp, kind=kind)

    def _phj_candidate(self, build_n: int, probe_n: int) -> QueryPlan | None:
        plan = self.pass_planner.plan(build_n)
        total_bits = plan.total_bits
        part_scale = self.online.scale_for("phj_partition")
        est_part, part_ratio = 0.0, 0.5
        for i, bits in enumerate(plan.schedule):
            m = self.pass_planner.pass_model(
                build_n, bits, device_g=self.partition_device_g,
                link=self.link)
            r, t_r = m.optimize_dd(delta=self.delta)
            m_s = self.pass_planner.pass_model(
                probe_n, bits, device_g=self.partition_device_g,
                link=self.link)
            _, t_s = m_s.optimize_dd(delta=self.delta)
            est_part += (t_r + t_s) * part_scale
            if i == 0:
                part_ratio = float(r)
        # Post-partition join: one ownership ratio across both sub-phases;
        # random accesses are partition-local, hence cache-resident
        # (rand_scale=1) — the whole point of paying for partitioning.
        steps = list(BUILD_SERIES.steps) + list(PROBE_SERIES.steps)
        m_join = self._series_model(steps, [build_n] * 4 + [probe_n] * 4,
                                    rand_scale=1.0)
        join_ratio, est_join = m_join.optimize_dd(delta=self.delta)
        est_join = est_join * self.online.scale_for("phj_join")
        return QueryPlan(
            algorithm="phj", scheme="DD",
            build_ratios=(part_ratio,) * 4, probe_ratios=(join_ratio,) * 4,
            num_buckets=default_num_buckets(build_n), max_out=0,
            est_s=est_part + est_join + self.phj_overhead_s,
            est_build_s=est_part,
            est_probe_s=est_join, schedule=plan.schedule,
            shj_bits=default_shj_bits(build_n, total_bits),
            partition_ratio=part_ratio, join_ratio=float(join_ratio))

    # -- the decision --------------------------------------------------------
    def choose(self, build_n: int, probe_n: int, *, max_out: int,
               cached: bool = False, expect_reuse: bool = False,
               c_load: float = 0.0, g_load: float = 0.0,
               kind: str = "inner", record: bool = True) -> QueryPlan:
        """Plan one query.

        ``kind``         — join-variant semantics; non-inner kinds run over
                           the SHJ probe path only (PHJ's partition-pair
                           ownership split has no variant emission), with
                           semi/anti priced without the p4 payload gather.
        ``cached``       — the build table is resident: probe-only SHJ.
        ``expect_reuse`` — this fingerprint has been seen before, so an SHJ
                           build is an investment the cache will amortize
                           (its cost is discounted by ``reuse_discount``).
        ``c_load``/``g_load`` — outstanding estimated seconds already
        admitted per group; added to each candidate in proportion to the
        share of that group it would use, so near-ties break toward the
        idler group and work from different queries overlaps.

        Plans are *sticky*: once a signature has been planned, the same
        plan (and therefore its ratios and slice shapes) is reused until the
        online calibration moves materially (``OnlineUnitCosts.version``).
        Load bias applies at (re)planning moments, not on every repeat of
        a hot signature.
        """
        sig = (build_n, probe_n, cached, expect_reuse,
               self._load_bucket(c_load, g_load), kind)

        def make_candidates():
            # A resident table does not *force* probe-only: at sizes
            # where the un-partitioned table is cache-hostile, re-running
            # PHJ can beat probing it — the sweep arbitrates (plan.cached
            # marks the winner).
            cands = list(self._shj_candidates(build_n, probe_n, cached,
                                              kind))
            if self.allow_phj and kind == "inner":
                phj = self._phj_candidate(build_n, probe_n)
                if phj is not None:
                    cands.append(phj)
            return cands

        def effective(p: QueryPlan) -> float:
            est = p.est_s
            if (expect_reuse and not cached and p.algorithm == "shj"):
                est = p.est_build_s * self.reuse_discount + p.est_probe_s
            if p.algorithm == "shj" and p.scheme not in ("CPU_ONLY",
                                                         "GPU_ONLY"):
                est = est * self.coproc_margin
            c = p.c_share
            return est + c * c_load + (1.0 - c) * g_load

        plan, from_cache = self._sticky_choose(
            sig, make_candidates, effective,
            keep_key=lambda p: (p.algorithm, p.scheme, p.cached),
            count_key=lambda p: (p.algorithm,
                                 "cached" if cached else p.scheme),
            record=record)
        if from_cache:
            return dataclasses.replace(plan, max_out=int(max_out))
        plan.max_out = int(max_out)
        return plan

    def choose_degraded(self, build_n: int, probe_n: int, *, max_out: int,
                        cached: bool = False, kind: str = "inner",
                        record: bool = True) -> QueryPlan:
        """The *cheapest* realizable plan — deadline-degraded execution.

        Admission uses this when a query's preferred plan already misses
        its deadline: raw minimum ``est_s`` over the same candidate set as
        ``choose``, with no co-processing handicap and no load bias (a
        degraded query wants out of the system as fast as possible, not a
        balanced placement).  A resident build table makes the probe-only
        variant the usual winner.  Sticky under its own signature, so
        degraded traffic reuses its plan like any other.
        """
        sig = ("degraded", build_n, probe_n, cached, kind)

        def make_candidates():
            cands = list(self._shj_candidates(build_n, probe_n, cached,
                                              kind))
            if self.allow_phj and kind == "inner":
                phj = self._phj_candidate(build_n, probe_n)
                if phj is not None:
                    cands.append(phj)
            return cands

        plan, from_cache = self._sticky_choose(
            sig, make_candidates, lambda p: p.est_s,
            keep_key=lambda p: (p.algorithm, p.scheme, p.cached),
            count_key=lambda p: (p.algorithm, "degraded"),
            record=record)
        if from_cache:
            return dataclasses.replace(plan, max_out=int(max_out))
        plan.max_out = int(max_out)
        return plan

    @staticmethod
    def _load_bucket(c_load: float, g_load: float) -> int:
        """Coarse load-imbalance bucket: plans stay sticky under balanced
        load, but a strongly lopsided group gets its own (sticky) variant
        — bounded to three variants per shape.  The dead zone is wide on
        purpose: each extra variant is another plan to warm."""
        if abs(c_load - g_load) <= max(0.5 * max(c_load, g_load), 0.2):
            return 0
        return 1 if c_load > g_load else -1

    def _sticky_choose(self, sig, make_candidates, effective, *,
                       keep_key, count_key, record: bool = True):
        """Sticky cost-model choice shared by join and group-by planning.

        A cached plan for ``sig`` is reused until the online calibration
        version moves; on a re-price, the incumbent (matched by
        ``keep_key``) is kept unless the challenger beats it by
        ``replan_margin`` (near-tie flips trade a warm plan for nothing).
        Returns ``(plan, from_cache)``.
        ``record=False`` skips the plan-count bookkeeping — admission-time
        pricing must not inflate the execution mix the benches report.
        """
        with self._lock:
            hit = self._plan_cache.get(sig)
        if hit is not None and hit[0] == self.online.version:
            plan = hit[1]
            if record:
                with self._lock:
                    k = count_key(plan)
                    self.plan_counts[k] = self.plan_counts.get(k, 0) + 1
            return plan, True
        candidates = make_candidates()
        best = min(candidates, key=effective)
        if hit is not None:
            prev = hit[1]
            keep = [p for p in candidates if keep_key(p) == keep_key(prev)]
            if keep and not self.replan_beats(effective(best),
                                              effective(keep[0])):
                best = keep[0]
        with self._lock:
            if len(self._plan_cache) > 512:
                self._plan_cache.clear()
            self._plan_cache[sig] = (self.online.version, best)
            if record:
                k = count_key(best)
                self.plan_counts[k] = self.plan_counts.get(k, 0) + 1
        return best, False

    def replan_beats(self, challenger_s: float, incumbent_s: float) -> bool:
        """The one replan-hysteresis rule: a challenger displaces an
        incumbent only by beating its estimate by ``replan_margin``.

        Shared by sticky per-stage re-pricing (above) and the executor's
        mid-pipeline order replans (``optimize.reprice_remaining``) —
        near-tie flips trade warm plans and warmed caches for nothing,
        so both layers apply the identical margin.
        """
        return float(challenger_s) < self.replan_margin * float(incumbent_s)

    def flag_replan(self, *, algorithm: str | None = None,
                    scheme: str | None = None) -> int:
        """Flag matching sticky plans for re-pricing (the drift hook).

        Marks every cached plan matching ``algorithm``/``scheme`` (None =
        any) with a version that can never equal ``online.version``, so
        the next ``choose`` for that signature re-prices through the
        normal ``_sticky_choose`` path — candidates re-swept, incumbent
        kept unless a challenger beats it by ``replan_margin``.  No new
        invalidation machinery: drift reuses the same hysteresis a
        calibration version tick does.  Returns how many cached plans
        were flagged.
        """
        n = 0
        with self._lock:
            for sig, (ver, plan) in list(self._plan_cache.items()):
                if algorithm is not None and plan.algorithm != algorithm:
                    continue
                if scheme is not None and plan.scheme != scheme:
                    continue
                if ver != -1:
                    self._plan_cache[sig] = (-1, plan)
                    n += 1
            self._replan_flags += n
        return n

    # -- group-by aggregation (ops subsystem) --------------------------------
    def _groupby_sweep(self, n: int):
        return self._sweep("groupby_agg", BUILD_SERIES.steps, [n] * 4,
                           rand_scale=self.table_rand_scale(n))

    def _groupby_single(self, n: int, scheme: str,
                        sweep=None) -> QueryPlan:
        """Unpartitioned group-by on one group: the sort is the hash table,
        priced as the build series (same sort + boundary + reduce shape)
        with the full-relation random-access penalty."""
        _, t = (sweep or self._groupby_sweep(n))[scheme]
        t = t * self.online.scale_for(f"groupby_agg:{scheme}")
        r = 1.0 if scheme == "CPU_ONLY" else 0.0
        return QueryPlan(
            algorithm="groupby", scheme=scheme, build_ratios=(r,) * 4,
            probe_ratios=(r,) * 4, num_buckets=0, max_out=0, est_s=t,
            est_build_s=0.0, est_probe_s=t, schedule=None,
            partition_ratio=r, join_ratio=r)

    def _groupby_separate(self, n: int) -> QueryPlan:
        """Row-split DD group-by, separate partials + host merge (the
        paper's Fig. 3 separate-tables mode applied to aggregation): each
        group aggregates its row share concurrently, partial group lists
        merge on the host.  The merge is O(groups) — priced as the same
        fixed overhead as PHJ's ownership exchange."""
        m = self._series_model(BUILD_SERIES.steps, [n] * 4,
                               rand_scale=self.table_rand_scale(n))
        r, t = m.optimize_dd(delta=self.delta)
        t = t * self.online.scale_for("groupby_agg:DD")
        return QueryPlan(
            algorithm="groupby", scheme="DD", table_mode="separate",
            build_ratios=(float(r),) * 4, probe_ratios=(float(r),) * 4,
            num_buckets=0, max_out=0, est_s=t + self.phj_overhead_s,
            est_build_s=0.0, est_probe_s=t, schedule=None,
            partition_ratio=float(r), join_ratio=float(r))

    def _groupby_coproc(self, n: int) -> QueryPlan:
        """Partitioned DD group-by: the PHJ skeleton priced for one
        relation — planner-chosen radix schedule, then a cache-resident
        per-partition reduce split at one ownership ratio."""
        plan = self.pass_planner.plan(n)
        part_scale = self.online.scale_for("groupby_partition")
        est_part, part_ratio = 0.0, 0.5
        for i, bits in enumerate(plan.schedule):
            m = self.pass_planner.pass_model(
                n, bits, device_g=self.partition_device_g, link=self.link)
            r, t = m.optimize_dd(delta=self.delta)
            est_part += t * part_scale
            if i == 0:
                part_ratio = float(r)
        m_agg = self._series_model(BUILD_SERIES.steps, [n] * 4,
                                   rand_scale=1.0)
        agg_ratio, est_agg = m_agg.optimize_dd(delta=self.delta)
        est_agg = est_agg * self.online.scale_for("groupby_agg:DD_part")
        return QueryPlan(
            algorithm="groupby", scheme="DD",
            build_ratios=(part_ratio,) * 4,
            probe_ratios=(float(agg_ratio),) * 4, num_buckets=0, max_out=0,
            est_s=est_part + est_agg + self.phj_overhead_s,
            est_build_s=est_part, est_probe_s=est_agg,
            schedule=plan.schedule, partition_ratio=part_ratio,
            join_ratio=float(agg_ratio))

    def choose_groupby(self, n: int, *, c_load: float = 0.0,
                       g_load: float = 0.0,
                       record: bool = True) -> QueryPlan:
        """Plan one group-by aggregation over ``n`` tuples.

        Candidates follow ``allowed_schemes``: whole-relation aggregation
        on either single group (CPU_ONLY / GPU_ONLY), the row-split
        separate-partials DD, and the radix-partitioned DD split under the
        same ``PassPlanner`` schedule and ``coproc_margin`` handicap as
        PHJ.  Plans are sticky per (n, load bucket) like join plans.
        """
        sig = ("groupby", n, self._load_bucket(c_load, g_load))

        def make_candidates():
            sweep = self._groupby_sweep(n)
            cands = [self._groupby_single(n, s, sweep)
                     for s in ("CPU_ONLY", "GPU_ONLY")
                     if s in self.allowed_schemes]
            if "DD" in self.allowed_schemes:
                cands.append(self._groupby_separate(n))
            if self.allow_phj:
                cands.append(self._groupby_coproc(n))
            # Degenerate scheme catalog (e.g. OL/PL-only): nothing above
            # is realizable for group-by, fall back to the larger group.
            return cands or [self._groupby_single(n, "GPU_ONLY", sweep)]

        def effective(p: QueryPlan) -> float:
            est = p.est_s * (self.coproc_margin if p.scheme == "DD" else 1.0)
            c = p.c_share
            return est + c * c_load + (1.0 - c) * g_load

        plan, _ = self._sticky_choose(
            sig, make_candidates, effective,
            keep_key=lambda p: (p.scheme, bool(p.schedule)),
            count_key=lambda p: ("groupby", p.scheme), record=record)
        return plan

    # -- feedback (satellite: close the calibration loop online) -----------
    @staticmethod
    def phase_pairs(plan: QueryPlan, timing
                    ) -> list[tuple[str, str, float, float]]:
        """``(phase, scheme, est_s, measured_s)`` pairs for one executed
        plan — the phases the plan actually priced, matched against the
        ``Timing`` the executor measured.  This is the single source of
        truth for both the online calibration feedback (``observe``) and
        the cost-model audit trail (``repro_torch.obs.CostAudit``)."""
        phases = timing.phase_s
        if plan.algorithm == "groupby":
            pairs = []
            if plan.schedule:
                pairs.append(("partition", plan.scheme, plan.est_build_s,
                              phases.get("partition", 0.0)))
            pairs.append(("agg", plan.scheme, plan.est_probe_s,
                          phases.get("agg", 0.0)))
            return pairs
        if plan.algorithm == "phj":
            return [("partition", plan.scheme, plan.est_build_s,
                     phases.get("partition", 0.0)),
                    ("join", plan.scheme, plan.est_probe_s,
                     phases.get("join", 0.0))]
        pairs = []
        if not plan.cached:
            pairs.append(("build", plan.scheme, plan.est_build_s,
                          phases.get("build", 0.0)))
        pairs.append(("probe", plan.scheme, plan.est_probe_s,
                      phases.get("probe", 0.0)))
        return pairs

    @staticmethod
    def _online_tag(plan: QueryPlan, phase: str) -> str:
        """The unit-cost series a (plan, phase) pair calibrates."""
        if plan.algorithm == "groupby":
            if phase == "partition":
                return "groupby_partition"
            return ("groupby_agg:DD_part" if plan.schedule
                    else f"groupby_agg:{plan.scheme}")
        if plan.algorithm == "phj":
            return "phj_partition" if phase == "partition" else "phj_join"
        if phase == "build":
            return f"shj_build:{plan.scheme}"
        probe_tag = ("shj_probe" if plan.kind == "inner"
                     else f"shj_probe[{plan.kind}]")
        return f"{probe_tag}:{plan.scheme}"

    def observe(self, plan: QueryPlan, timing) -> None:
        """Fold one executed query's measured phase times back in."""
        for phase, _scheme, est_s, measured_s in self.phase_pairs(plan,
                                                                  timing):
            self.online.observe(self._online_tag(plan, phase), est_s,
                                measured_s)

    def stats(self) -> dict:
        with self._lock:
            counts = {f"{a}/{s}": n for (a, s), n in
                      sorted(self.plan_counts.items())}
            replan_flags = self._replan_flags
        return {"plan_counts": counts, "replan_flags": replan_flags,
                "online": self.online.to_dict()}
