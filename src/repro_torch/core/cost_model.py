"""The paper's unified co-processing cost model (§4, Table 2, Eqs. 1–5).

A copy of ``repro/core/cost_model.py`` (NumPy only), so the port needs
nothing from the JAX package.

Abstract model: a step series s_1..s_n with x_i input items at step i and a
CPU-side workload ratio r_i.  For each processor group XPU in {C, G}:

    T = max(T_C, T_G)                                               (Eq. 1)
    T_XPU = sum_i (C^i_XPU + M^i_XPU + D^i_XPU [+ L^i_XPU])        (Eq. 2)
    C^i + M^i = u^i_XPU * share_i * x_i                            (Eq. 3 +
                 calibrated memory term; u = sec/item from calibrate.py)
    D^i per Eqs. 4/5 (pipeline delay from ratio mismatch)
    L^i = link term (our TPU extension, DESIGN.md §7): moved items between
          groups when consecutive ratios differ, priced at ICI (coupled) or
          DCN/PCIe (discrete) latency+bandwidth.  On discrete, DD/OL also
          pay input shipping and result return (the paper's Fig. 3 bars).

Eqs. 4/5 reference T of the *current* step on the opposite group; to avoid
the circular definition we use the step's work time (C+M) for step i and the
full cumulative time (incl. D, L) for steps < i — this matches the paper's
described semantics ("time from Step 1 to the end of the pipelined
execution area").

The δ-sweep optimizer (§3.2, δ=0.02) evaluates the model over the full
ratio grid (vectorized over grid points), with DD (all-equal ratios) and OL
(0/1 ratios) as restricted sweeps — the paper's observation that DD and OL
are special cases of PL.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """Inter-group link: ICI for coupled pods, DCN/PCIe for discrete."""

    name: str
    latency_s: float
    bw_bytes_per_s: float

    def xfer_time(self, nbytes) -> np.ndarray:
        nbytes = np.asarray(nbytes, dtype=np.float64)
        return np.where(nbytes > 0, self.latency_s + nbytes / self.bw_bytes_per_s, 0.0)


# Paper §5.1 emulates PCIe with latency 0.015 ms, bw 3 GB/s.
PCIE_LINK = LinkSpec("pcie_emulated", 0.015e-3, 3e9)
# TPU v5e: ~50 GB/s/link ICI, ~1 us software latency (coupled analogue).
ICI_LINK = LinkSpec("ici", 1e-6, 50e9)
# Cross-pod DCN (discrete analogue at pod scale).
DCN_LINK = LinkSpec("dcn", 25e-6, 3.2e9)
# Same-host zero-copy (what the CPU-only benches actually traverse).
ZEROCOPY_LINK = LinkSpec("zerocopy", 2e-7, 40e9)


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Analytic throughput of one processor group (seeds u when no
    measured calibration is available; see calibrate.py)."""

    name: str
    ops_per_s: float
    seq_bw_bytes_per_s: float
    rand_access_per_s: float

    def unit_cost(self, cost) -> float:
        """Seconds/item from a StepCost (paper Eq. 3 + memory term)."""
        return (cost.ops_per_item / self.ops_per_s
                + cost.seq_bytes_per_item / self.seq_bw_bytes_per_s
                + cost.rand_accesses_per_item / self.rand_access_per_s)


@dataclasses.dataclass
class CostBreakdown:
    total: float
    t_c: float
    t_g: float
    per_step_c: np.ndarray   # (n,) work time on C
    per_step_g: np.ndarray   # (n,) work time on G
    delay_c: np.ndarray
    delay_g: np.ndarray
    link: np.ndarray         # (n,) link time charged at each boundary


class SeriesCostModel:
    """Cost model for one step series (between barriers)."""

    def __init__(self, step_names, u_c, u_g, x, out_bytes, link: LinkSpec,
                 *, discrete: bool = False, item_bytes: float = 8.0):
        self.step_names = list(step_names)
        self.u_c = np.asarray(u_c, dtype=np.float64)
        self.u_g = np.asarray(u_g, dtype=np.float64)
        self.x = np.asarray(x, dtype=np.float64)
        self.out_bytes = np.asarray(out_bytes, dtype=np.float64)
        self.link = link
        self.discrete = discrete
        self.item_bytes = item_bytes
        self.n = len(self.step_names)
        assert self.u_c.shape == (self.n,)

    # -- vectorized evaluation over a batch of ratio assignments ------------
    def estimate_batch(self, ratios: np.ndarray) -> np.ndarray:
        """ratios: (m, n) in [0,1].  Returns (m,) total series time."""
        r = np.asarray(ratios, dtype=np.float64)
        if r.ndim == 1:
            r = r[None, :]
        m, n = r.shape
        w_c = self.u_c * r * self.x                  # (m, n) work time on C
        w_g = self.u_g * (1.0 - r) * self.x          # (m, n)
        cum_c = np.zeros(m)
        cum_g = np.zeros(m)
        for i in range(n):
            d_c = np.zeros(m)
            d_g = np.zeros(m)
            l_i = np.zeros(m)
            if i > 0:
                dr = r[:, i] - r[:, i - 1]
                # Eq. 4: CPU waits for GPU output of step i-1.
                up = dr > 0
                denom = np.maximum(1.0 - r[:, i - 1], 1e-12)
                not_piped = w_g[:, i - 1] * (1.0 - r[:, i]) / denom
                d_c = np.where(up, np.maximum(
                    0.0, (cum_g - not_piped) - (cum_c + w_c[:, i])), 0.0)
                # Eq. 5: GPU waits for CPU output of step i-1.
                dn = dr < 0
                denom2 = np.maximum(1.0 - r[:, i], 1e-12)
                not_piped2 = w_g[:, i] * (1.0 - r[:, i - 1]) / denom2
                d_g = np.where(dn, np.maximum(
                    0.0, cum_c - (cum_g + w_g[:, i] - not_piped2)), 0.0)
                # Link: |dr| * x_i items of the previous step's output cross
                # the groups.
                moved = np.abs(dr) * self.x[i] * self.out_bytes[i - 1]
                l_i = self.link.xfer_time(moved)
            elif self.discrete:
                # Discrete: ship the G-group's input share over the bus.
                l_i = self.link.xfer_time((1.0 - r[:, 0]) * self.x[0]
                                          * self.item_bytes)
            cum_c = cum_c + w_c[:, i] + d_c + l_i
            cum_g = cum_g + w_g[:, i] + d_g + l_i
        if self.discrete:
            # Result return for the G-group share of the last step.
            back = self.link.xfer_time((1.0 - r[:, -1]) * self.x[-1]
                                       * self.out_bytes[-1])
            cum_g = cum_g + back
        return np.maximum(cum_c, cum_g)

    def estimate(self, ratios) -> CostBreakdown:
        """Detailed single-assignment estimate with per-step breakdown."""
        r = np.asarray(ratios, dtype=np.float64)
        n = self.n
        w_c = self.u_c * r * self.x
        w_g = self.u_g * (1.0 - r) * self.x
        d_c = np.zeros(n)
        d_g = np.zeros(n)
        l = np.zeros(n)
        cum_c = cum_g = 0.0
        for i in range(n):
            if i > 0:
                dr = r[i] - r[i - 1]
                if dr > 0:
                    denom = max(1.0 - r[i - 1], 1e-12)
                    not_piped = w_g[i - 1] * (1.0 - r[i]) / denom
                    d_c[i] = max(0.0, (cum_g - not_piped) - (cum_c + w_c[i]))
                elif dr < 0:
                    denom = max(1.0 - r[i], 1e-12)
                    not_piped = w_g[i] * (1.0 - r[i - 1]) / denom
                    d_g[i] = max(0.0, cum_c - (cum_g + w_g[i] - not_piped))
                l[i] = float(self.link.xfer_time(abs(dr) * self.x[i]
                                                 * self.out_bytes[i - 1]))
            elif self.discrete:
                l[i] = float(self.link.xfer_time((1.0 - r[0]) * self.x[0]
                                                 * self.item_bytes))
            cum_c += w_c[i] + d_c[i] + l[i]
            cum_g += w_g[i] + d_g[i] + l[i]
        if self.discrete:
            cum_g += float(self.link.xfer_time((1.0 - r[-1]) * self.x[-1]
                                               * self.out_bytes[-1]))
        return CostBreakdown(max(cum_c, cum_g), cum_c, cum_g, w_c, w_g,
                             d_c, d_g, l)

    # -- δ-sweep optimizers (paper §3.2) -------------------------------------
    def _grid(self, delta: float) -> np.ndarray:
        k = int(round(1.0 / delta))
        return np.linspace(0.0, 1.0, k + 1)

    def optimize_pl(self, delta: float = 0.02,
                    max_grid: int = 20_000_000) -> tuple[np.ndarray, float]:
        """Full PL sweep over the δ-grid of per-step ratios.

        Falls back to cyclic coordinate descent when the full grid would
        exceed ``max_grid`` points (n > 4 at δ=0.02) — each sweep is exact
        per coordinate, iterated to a fixed point.
        """
        g = self._grid(delta)
        if len(g) ** self.n <= max_grid:
            mesh = np.stack(np.meshgrid(*([g] * self.n), indexing="ij"),
                            axis=-1).reshape(-1, self.n)
            t = self.estimate_batch(mesh)
            i = int(np.argmin(t))
            return mesh[i], float(t[i])
        r = np.full(self.n, 0.5)
        best = float(self.estimate_batch(r[None])[0])
        for _ in range(16):
            improved = False
            for i in range(self.n):
                cand = np.repeat(r[None], len(g), axis=0)
                cand[:, i] = g
                t = self.estimate_batch(cand)
                j = int(np.argmin(t))
                if t[j] < best - 1e-15:
                    best, r = float(t[j]), cand[j]
                    improved = True
            if not improved:
                break
        return r, best

    def optimize_dd(self, delta: float = 0.02) -> tuple[float, float]:
        """DD: one ratio for every step (PL restricted to equal ratios)."""
        g = self._grid(delta)
        mesh = np.repeat(g[:, None], self.n, axis=1)
        t = self.estimate_batch(mesh)
        i = int(np.argmin(t))
        return float(g[i]), float(t[i])

    def optimize_ol(self) -> tuple[np.ndarray, float]:
        """OL: each step wholly on C (r=1) or wholly on G (r=0): 2^n plans."""
        plans = np.array(list(itertools.product([0.0, 1.0], repeat=self.n)))
        t = self.estimate_batch(plans)
        i = int(np.argmin(t))
        return plans[i], float(t[i])

    def scheme_sweep(self, delta: float = 0.05,
                     schemes: tuple[str, ...] | None = None
                     ) -> dict[str, tuple[np.ndarray, float]]:
        """Best ratio assignment + estimate per named scheme (§3.2).

        Returns ``{scheme: (ratios, est_s)}`` over the requested subset of
        CPU_ONLY / GPU_ONLY / OL / DD / PL — the engine's planner picks the
        argmin per query instead of taking hard-coded knobs.
        """
        out: dict[str, tuple[np.ndarray, float]] = {}
        want = schemes or ("CPU_ONLY", "GPU_ONLY", "OL", "DD", "PL")
        ones = np.ones(self.n)
        if "CPU_ONLY" in want:
            out["CPU_ONLY"] = (ones, float(self.estimate_batch(ones)[0]))
        if "GPU_ONLY" in want:
            zeros = np.zeros(self.n)
            out["GPU_ONLY"] = (zeros, float(self.estimate_batch(zeros)[0]))
        if "OL" in want:
            r, t = self.optimize_ol()
            out["OL"] = (r, t)
        if "DD" in want:
            r, t = self.optimize_dd(delta=delta)
            out["DD"] = (np.full(self.n, r), t)
        if "PL" in want:
            r, t = self.optimize_pl(delta=delta)
            out["PL"] = (r, t)
        return out

    def monte_carlo(self, num: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Random ratio assignments + their estimates (paper Fig. 9)."""
        rng = np.random.default_rng(seed)
        ratios = rng.uniform(0.0, 1.0, size=(num, self.n))
        return ratios, self.estimate_batch(ratios)


def series_model_from_costs(steps, x, device_c: DeviceSpec,
                            device_g: DeviceSpec, link: LinkSpec,
                            *, discrete: bool = False,
                            u_overrides: dict | None = None) -> SeriesCostModel:
    """Build a model from StepCost seeds, optionally overridden by measured
    per-step unit costs from calibrate.py (paper §4.2 instantiation)."""
    names = [s.name for s in steps]
    u_c = np.array([device_c.unit_cost(s.cost) for s in steps])
    u_g = np.array([device_g.unit_cost(s.cost) for s in steps])
    if u_overrides:
        for i, nm in enumerate(names):
            if nm in u_overrides:
                u_c[i], u_g[i] = u_overrides[nm]
    out_bytes = np.array([s.cost.out_bytes_per_item for s in steps])
    return SeriesCostModel(names, u_c, u_g, np.asarray(x, dtype=np.float64),
                           out_bytes, link, discrete=discrete)
