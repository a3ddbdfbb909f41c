"""Two-group co-processing executor: the SHJ and PHJ schemes (§3.2).

Counterpart of ``repro/core/coprocess.py``.  The paper's CPU-GPU pair is a
C group on the host CPU and a G group on the card (``c_device="cpu"``,
``g_device="cuda:0"``); the JAX package emulates it with two groups of one
backend.  Both groups may be given the same device, as tests do with
``"cpu"``.  The C share of every step runs the kernels' plain versions on
the host; the G share runs the Hopper kernels.

Schemes:
  * CPU_ONLY / GPU_ONLY: the whole series on one group.
  * OL: per-step 0/1 assignment.
  * DD: one ratio for all steps of a phase; separate tables need a merge.
  * PL: per-step ratios.  ``shj`` cuts each phase at its first step's
    ratio, as the JAX package does.
  * BASIC_UNIT (``basic_unit_shj``): the appendix's dynamic chunk
    scheduling.

Build-table modes (§3.3) of ``shj`` / ``build_table``:
  * separate: each group builds a partial table on its tuple share; the C
    group merges them (the paper's Fig. 3 merge).
  * shared: bucket-range ownership split between the groups; tuples move
    to their owner, and the two ranges concatenate into one table on G.

``CoProcessor.phj`` splits the partition passes by ``partition_ratio``
(the C share of each relation's tuples) and the join phase by
``join_ratio`` (the C share of the partition pairs).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from functools import partial

import torch

from . import hash_table as ht
from .cost_model import LinkSpec, ZEROCOPY_LINK
from .partition import partition_pass, radix_partition_scheduled
from .phj import partitioned_join, resolve_schedule
from .relation import Relation, bucket_of, radix_of, resolve_device
from .shj import concat_results

# The span of each side's partition passes inside the ``partition`` phase.
PARTITION_SPANS = {"R": "partition.build", "S": "partition.probe"}


def _round_up(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def owned_slice(rel: Relation, pid: torch.Tensor, lo: int, hi: int,
                lcm: int, sentinel: int) -> tuple[Relation, int]:
    """The tuples of ``rel`` whose partition id lies in ``[lo, hi)``.

    Selected with a mask on the device that holds ``rel`` and ``pid``
    (``nonzero`` keeps their order) and padded to a multiple of ``lcm``
    with pad tuples (rid INVALID, key ``sentinel``).  Returns the slice and
    its number of real tuples, the only value that leaves the device.
    """
    idx = torch.nonzero((pid >= lo) & (pid < hi)).squeeze(1)
    k = int(idx.shape[0])
    m = _round_up(max(k, 1), lcm)
    rid = torch.full((m,), ht.INVALID, dtype=torch.int32, device=rel.device)
    key = torch.full((m,), sentinel, dtype=torch.int32, device=rel.device)
    rid[:k] = rel.rid[idx]
    key[:k] = rel.key[idx]
    return Relation(rid, key), k


# Fault-injection hook: an injector plants its ``maybe_fault`` here (and
# sets it back to None), so the hot path costs one load and one branch
# when none is active.  Sites: "h2d", "kernel", "d2h".
_FAULT_HOOK = None


def _maybe_fault(site: str) -> None:
    hook = _FAULT_HOOK
    if hook is not None:
        hook(site)


@dataclasses.dataclass
class Timing:
    wall_s: float = 0.0
    phase_s: dict = dataclasses.field(default_factory=dict)
    transfer_bytes: int = 0
    transfer_s: float = 0.0
    merge_s: float = 0.0
    notes: dict = dataclasses.field(default_factory=dict)
    # Phases timed through ``phase()`` also emit spans on this tracer.
    tracer: object = dataclasses.field(default=None, repr=False,
                                       compare=False)

    @contextlib.contextmanager
    def phase(self, name: str, *, sync=None, **attrs):
        """Time a phase into ``phase_s[name]`` (and span it when traced).

        ``sync`` runs before the clock stops: on a CUDA group it is
        ``torch.cuda.synchronize``, so the phase time covers the device
        work and not only its launches.  Seconds come from
        ``time.perf_counter``.
        """
        tracer = self.tracer
        traced = tracer is not None and getattr(tracer, "enabled", False)
        ctx = tracer.span(name, **attrs) if traced else \
            contextlib.nullcontext()
        with ctx:
            t0 = time.perf_counter()
            try:
                yield self
            finally:
                if sync is not None:
                    sync()
                self.phase_s[name] = time.perf_counter() - t0

    def to_dict(self) -> dict:
        """JSON-serializable view."""
        return {
            "wall_s": float(self.wall_s),
            "phase_s": {k: float(v) for k, v in self.phase_s.items()},
            "transfer_bytes": int(self.transfer_bytes),
            "transfer_s": float(self.transfer_s),
            "merge_s": float(self.merge_s),
            "notes": {k: (v if isinstance(v, (int, float, str, bool, list))
                          else str(v)) for k, v in self.notes.items()},
        }


def _move(obj, device):
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _move(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_move(v, device) for v in obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj     # static step state (a pass's shift and bits)
    return obj.to(device)  # Relation, HashTable, JoinResult


class DeviceGroup:
    """One device acting as a logical processor (C or G)."""

    def __init__(self, name: str, device):
        self.name = name
        self.device = resolve_device(device)

    @property
    def size(self) -> int:
        return 1

    def put_items(self, tree):
        """Place per-item tensors (or a Relation) on the group."""
        _maybe_fault("h2d")
        return _move(tree, self.device)

    def put_shared(self, tree):
        return _move(tree, self.device)

    def launch(self, fn):
        """``fn`` wrapped with the kernel-launch fault site (the place of
        the JAX package's per-group ``jit``)."""
        def run(*args, **kw):
            _maybe_fault("kernel")
            return fn(*args, **kw)
        return run

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class CoProcessor:
    """Executes SHJ and PHJ across a C group and a G group."""

    BUILD_PAD_KEY = -2   # sentinel keys: pads never match real (>=0) keys
    PROBE_PAD_KEY = -3

    def __init__(self, c_device="cpu", g_device="cuda:0", *,
                 link: LinkSpec = ZEROCOPY_LINK, discrete: bool = False,
                 ratio_quantum: int = 64, tracer=None):
        from ..obs import NULL_TRACER
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.c = DeviceGroup("C", c_device)
        self.g = DeviceGroup("G", g_device)
        # Per-group execution locks for concurrent callers (the engine's
        # worker threads); acquire in fixed C-then-G order.
        self.group_locks = {"C": threading.Lock(), "G": threading.Lock()}
        self.link = link
        self.discrete = discrete
        self.ratio_quantum = ratio_quantum
        # Cuts and relation sizes are kept multiples of this.
        self.lcm = math.lcm(self.c.size, self.g.size)

    def synchronize(self) -> None:
        self.c.synchronize()
        self.g.synchronize()

    def pad_relation(self, rel: Relation, sentinel: int) -> Relation:
        n = rel.size
        m = _round_up(n, self.lcm)
        if m == n:
            return rel
        pad = m - n
        dev = rel.device
        return Relation(
            torch.cat([rel.rid, torch.full((pad,), ht.INVALID,
                                           dtype=torch.int32, device=dev)]),
            torch.cat([rel.key, torch.full((pad,), sentinel,
                                           dtype=torch.int32, device=dev)]))

    # Emulated bus (paper §5.1: delay = latency + size/bandwidth).
    def _bus_delay(self, nbytes: int, timing: Timing):
        timing.transfer_bytes += int(nbytes)
        if self.discrete and nbytes > 0:
            d = float(self.link.xfer_time(nbytes))
            timing.transfer_s += d
            time.sleep(d)

    def _cut(self, n: int, ratio: float) -> int:
        """Quantized split point, exact at the endpoints: ratio 0/1 gives
        the WHOLE relation to one group."""
        if ratio <= 0.0:
            return 0
        if ratio >= 1.0:
            return n
        q = max(self.lcm, _round_up(n // self.ratio_quantum, self.lcm))
        cut = int(round(ratio * n / q)) * q
        return min(n, max(0, cut))

    def _slices(self, rel: Relation, ratio: float, timing: Timing):
        """``rel`` split at the quantized cut: [:cut] to C, the rest to G."""
        n = rel.size
        cut = self._cut(n, ratio)
        if self.discrete and 0 < cut < n:
            self._bus_delay((n - cut) * 8, timing)
        out = []
        if cut > 0:
            out.append((self.c, self.c.put_items(rel.take(0, cut))))
        if cut < n:
            out.append((self.g, self.g.put_items(rel.take(cut, n))))
        return out

    def _collect(self, pieces: list[Relation]) -> Relation:
        """Concatenate per-group pieces in C-then-G order.  One piece stays
        where it is; two meet on the G device, which holds the larger
        share of the work in the schemes the paper finds best."""
        if len(pieces) == 1:
            return pieces[0]
        dev = self.g.device
        return Relation(torch.cat([p.rid.to(dev) for p in pieces]),
                        torch.cat([p.key.to(dev) for p in pieces]))

    # ------------------------------------------------------------------
    # Map-series execution with per-step ratios (PL backbone).
    # ------------------------------------------------------------------
    def run_map_series(self, series, shared, items, ratios,
                       timing: Timing | None = None):
        """Run splittable map steps with per-step ratios.

        Boundary rule (paper Fig. 2): when r_i != r_{i-1}, the slice between
        the two cut points moves across groups: a real host <-> card copy
        when the groups are the host and the card, plus the emulated bus
        delay in discrete mode.  ``Timing.transfer_bytes`` counts the
        emulated bytes only, as the JAX package does.  Returns
        ``(items_c, items_g, extra_shared, timing)``: each group's items
        on its device, and the steps' combined partial outputs on C's.
        """
        timing = timing or Timing(tracer=self.tracer)
        n = next(iter(items.values())).shape[0]
        shared_c = self.c.put_shared(shared)
        shared_g = self.g.put_shared(shared)
        cut = self._cut(n, ratios[0])
        items_c = self.c.put_items({k: v[:cut] for k, v in items.items()})
        items_g = self.g.put_items({k: v[cut:] for k, v in items.items()})
        if self.discrete:
            moved = sum((math.prod(v.shape[1:]) or 1) * v.element_size()
                        * (n - cut) for v in items.values())
            self._bus_delay(moved, timing)
        extra_shared: dict = {}
        for i, step in enumerate(series.steps):
            new_cut = self._cut(n, ratios[i])
            if new_cut != cut:
                items_c, items_g, moved = self._move_boundary(
                    items_c, items_g, cut, new_cut)
                self._bus_delay(moved, timing)
                cut = new_cut
            # G first: its launches return at once, so the card works
            # while the host runs C's share.
            out_g, sh_g = self.g.launch(step.apply)(shared_g, items_g)
            out_c, sh_c = self.c.launch(step.apply)(shared_c, items_c)
            items_c, items_g = out_c, out_g
            for k, how in step.combine.items():
                a, b = sh_c.get(k), sh_g.get(k)
                if how == "add":
                    extra_shared[k] = a.to(self.c.device) + \
                        b.to(self.c.device)
                elif how == "list":
                    extra_shared.setdefault(k, []).extend(
                        (a if isinstance(a, list) else [a]) +
                        (b if isinstance(b, list) else [b]))
        return items_c, items_g, extra_shared, timing

    def _move_boundary(self, items_c, items_g, cut, new_cut):
        """Move the [min(cut,new_cut), max) slice between the groups.

        Only the moving slice crosses devices; the rest of each group's
        items stays where it is.  Returns the new items and the bytes
        moved."""
        if new_cut > cut:            # C takes more: head of G moves to C
            take = new_cut - cut
            head = {k: v[:take].to(self.c.device) for k, v in items_g.items()}
            moved_bytes = sum(v.numel() * v.element_size()
                              for v in head.values())
            items_c = self.c.put_items(
                {k: torch.cat([items_c[k], head[k]]) for k in items_c})
            items_g = self.g.put_items(
                {k: v[take:] for k, v in items_g.items()})
        else:                        # G takes more: tail of C moves to G
            take = cut - new_cut
            tail = {k: v[v.shape[0] - take:].to(self.g.device)
                    for k, v in items_c.items()}
            moved_bytes = sum(v.numel() * v.element_size()
                              for v in tail.values())
            items_g = self.g.put_items(
                {k: torch.cat([tail[k], items_g[k]]) for k in items_g})
            items_c = self.c.put_items(
                {k: v[: v.shape[0] - take] for k, v in items_c.items()})
        return items_c, items_g, moved_bytes

    # ------------------------------------------------------------------
    # SHJ under a scheme.
    # ------------------------------------------------------------------
    def shj(self, build_rel: Relation, probe_rel: Relation, *,
            num_buckets: int, max_out: int, build_ratios, probe_ratios,
            table_mode: str = "shared") -> tuple[ht.JoinResult, Timing]:
        """Run SHJ with per-step ratios (len-4 each; DD = equal entries,
        OL = 0/1 entries, CPU_ONLY = all 1, GPU_ONLY = all 0)."""
        table, timing = self.build_table(build_rel, num_buckets=num_buckets,
                                         ratios=build_ratios,
                                         table_mode=table_mode)
        result, timing = self.probe_table(probe_rel, table, max_out=max_out,
                                          ratios=probe_ratios, timing=timing)
        timing.wall_s = timing.phase_s["build"] + timing.phase_s["probe"]
        return result, timing

    def build_table(self, build_rel: Relation, *, num_buckets: int, ratios,
                    table_mode: str = "shared",
                    timing: Timing | None = None
                    ) -> tuple[ht.HashTable, Timing]:
        """Build phase only, returning the finished table (which the
        engine's table cache keeps for later probes)."""
        if table_mode not in ("shared", "separate"):
            raise ValueError(f"table_mode must be 'shared' or 'separate': "
                             f"{table_mode!r}")
        timing = timing or Timing(tracer=self.tracer)
        build_rel = self.pad_relation(build_rel, self.BUILD_PAD_KEY)
        with timing.phase("build", sync=self.synchronize, n=build_rel.size):
            table = self._build(build_rel, num_buckets, ratios, table_mode,
                                timing)
        return table, timing

    def probe_table(self, probe_rel: Relation, table: ht.HashTable, *,
                    max_out: int, ratios, timing: Timing | None = None,
                    probe_fn=None, tag: str = "probe"
                    ) -> tuple[ht.JoinResult, Timing]:
        """Probe phase against an existing (possibly cached) table.

        ``probe_fn(max_out)`` returns the per-group probe ``(rel, table) ->
        JoinResult`` in place of ``probe_hash_table`` (the join variants of
        ``repro_torch.ops.join_variants`` route through here); ``tag``
        names the kernel family, as the JAX package's jit cache key does.
        """
        timing = timing or Timing(tracer=self.tracer)
        probe_rel = self.pad_relation(probe_rel, self.PROBE_PAD_KEY)
        with timing.phase("probe", sync=self.synchronize, n=probe_rel.size,
                          tag=tag):
            result = self._probe(probe_rel, table, max_out, ratios, timing,
                                 probe_fn=probe_fn)
        if not timing.wall_s:
            timing.wall_s = timing.phase_s.get("build", 0.0) + \
                timing.phase_s["probe"]
        return result, timing

    def _build(self, rel: Relation, num_buckets: int, ratios, table_mode,
               timing: Timing) -> ht.HashTable:
        n = rel.size
        r1 = ratios[0]
        cut = self._cut(n, r1)
        if table_mode == "separate" and 0 < cut < n:
            # Each group builds a partial table on its share; C merges.
            rel_c = self.c.put_items(rel.take(0, cut))
            rel_g = self.g.put_items(rel.take(cut, n))
            if self.discrete:
                self._bus_delay((n - cut) * 8, timing)
            # G first, here and below: its launches return at once, so the
            # card works while the host computes C's share.
            part_g = self.g.launch(ht.build_hash_table)(rel_g, num_buckets)
            part_c = self.c.launch(ht.build_hash_table)(rel_c, num_buckets)
            self.synchronize()
            tm = time.perf_counter()
            if self.discrete:  # ship the partial table back over the bus
                self._bus_delay(part_g.nbytes, timing)
            table = self.c.launch(ht.merge_hash_tables)(
                [part_c, self.c.put_shared(part_g)], num_buckets)
            self.c.synchronize()
            timing.merge_s = time.perf_counter() - tm
            return table
        # Shared table (or one group): bucket-range ownership.  C owns
        # buckets [0, own_c); each group builds its range from the tuples
        # it owns, and the ranges concatenate into ONE table (no merge).
        own_c = self._cut(num_buckets, r1) if 0 < cut < n else \
            (num_buckets if cut == n else 0)
        if own_c in (0, num_buckets):
            grp = self.c if own_c == num_buckets else self.g
            if self.discrete and grp is self.g:
                self._bus_delay(n * 8, timing)
            return grp.launch(ht.build_hash_table)(grp.put_items(rel),
                                                   num_buckets)
        to_c = bucket_of(rel.key, num_buckets) < own_c
        # Owners contiguous: a stable sort of an int8 flag (C first).
        order = torch.sort((~to_c).to(torch.int8), stable=True).indices
        n_c = int(to_c.sum())
        srel = Relation(rel.rid[order], rel.key[order])
        # Exchange: tuples cross groups to reach their owner (the discrete
        # bus pays for the crossing part).
        crossing = min(n_c, n - cut) + min(n - n_c, cut)
        self._bus_delay(crossing * 8, timing)
        n_c_pad = _round_up(max(n_c, 1), self.lcm)
        n_g_pad = _round_up(max(n - n_c, 1), self.lcm)
        rel_c = self.c.put_items(_pad_slice(srel, 0, n_c, n_c_pad,
                                            self.BUILD_PAD_KEY))
        rel_g = self.g.put_items(_pad_slice(srel, n_c, n, n_g_pad,
                                            self.BUILD_PAD_KEY))
        part_g = self.g.launch(ht.build_hash_table)(rel_g, num_buckets)
        part_c = self.c.launch(ht.build_hash_table)(rel_c, num_buckets)
        return _concat_bucket_ranges(self.g.put_shared(part_c), part_g,
                                     own_c)

    def _probe(self, rel: Relation, table: ht.HashTable, max_out: int,
               ratios, timing: Timing, *, probe_fn=None) -> ht.JoinResult:
        n = rel.size
        cut = self._cut(n, ratios[0])
        # The table goes to each group that probes (discrete: the G copy
        # pays the bus once, with G's share of the probe tuples).
        if self.discrete and cut < n:
            self._bus_delay(table.nbytes + (n - cut) * 8, timing)
        # Per-group result capacity: proportional to the tuple share, plus
        # slack covering statistical fluctuation of the match density (a
        # proportional cap with O(1) slack truncates skewed probes).
        slack = max(64, max_out // 16)
        max_c = max(1, _round_up(int(max_out * (cut / max(n, 1))), 8) + slack)
        max_g = max(1, max_out - max_c + 2 * slack)

        if probe_fn is None:
            def probe_fn(mo):
                return lambda r, t: ht.probe_hash_table(r, t, mo)

        res = []   # C's result first, G's after
        if cut < n:
            res.append(self.g.launch(probe_fn(max_g))(
                self.g.put_items(rel.take(cut, n)),
                self.g.put_shared(table)))
        if cut > 0:
            res.insert(0, self.c.launch(probe_fn(max_c))(
                self.c.put_items(rel.take(0, cut)),
                self.c.put_shared(table)))
        if len(res) == 1:
            out = res[0]
            if self.discrete:
                self._bus_delay(int(out.count) * 8, timing)
            if out.probe_rid.shape[0] > max_out:
                # The per-group slack padded capacity past the caller's
                # max_out; valid pairs are front-compacted, so a prefix
                # keeps the first matches.
                out = ht.JoinResult(out.probe_rid[:max_out],
                                    out.build_rid[:max_out],
                                    torch.clamp(out.count, max=max_out))
            return out
        if self.discrete:
            self._bus_delay(int(res[1].count) * 8, timing)
        return concat_results([self.c.put_shared(r) for r in res],
                              max_out=max_out)

    # ------------------------------------------------------------------
    # Appendix A: BasicUnit, coarse-grained dynamic chunk scheduling.
    # ------------------------------------------------------------------
    def basic_unit_shj(self, build_rel: Relation, probe_rel: Relation, *,
                       num_buckets: int, max_out: int, chunk: int = 4096
                       ) -> tuple[ht.JoinResult, Timing, dict]:
        """Chunks of tuples dynamically assigned to whichever group is free.

        Greedy least-loaded assignment from one timed chunk per group (the
        appendix's dynamic queue), then the assigned work.  Partial tables
        merge, and outputs concatenate, in chunk order, so the result does
        not depend on the schedule.  Returns the realized per-phase C
        ratios (appendix Figs. 17/18)."""
        timing = Timing()
        build_rel = self.pad_relation(build_rel, self.BUILD_PAD_KEY)
        probe_rel = self.pad_relation(probe_rel, self.PROBE_PAD_KEY)
        chunk = _round_up(chunk, self.lcm)
        groups = {"C": self.c, "G": self.g}
        ratios = {}

        def assign(n_items, t_c, t_g):
            load_c = load_g = 0.0
            sched = []
            for _ in range(-(-n_items // chunk)):  # the dynamic queue
                if load_c + t_c <= load_g + t_g:
                    sched.append("C")
                    load_c += t_c
                else:
                    sched.append("G")
                    load_g += t_g
            return sched

        def run(rel, sentinel, fn):
            """Time one chunk per group, then run every chunk on its
            group (``fn(name)(chunk)``); returns the outputs in chunk
            order and the C ratio."""
            cal = rel.take(0, chunk)
            sched = assign(rel.size, *(
                _time_once(grp, fn(name), grp.put_items(cal))
                for name, grp in groups.items()))
            outs = []
            for i, who in enumerate(sched):
                lo = i * chunk
                hi = min(rel.size, lo + chunk)
                sl = _pad_slice(rel, lo, hi, chunk, sentinel)
                outs.append(fn(who)(groups[who].put_items(sl)))
            return outs, sched.count("C") / max(len(sched), 1)

        t0 = time.perf_counter()
        partials, ratios["build"] = run(
            build_rel, self.BUILD_PAD_KEY,
            lambda name: partial(groups[name].launch(ht.build_hash_table),
                                 num_buckets=num_buckets))
        table = self.c.launch(ht.merge_hash_tables)(
            [self.c.put_shared(t) for t in partials], num_buckets)
        self.synchronize()
        t1 = time.perf_counter()
        timing.phase_s["build"] = t1 - t0

        mo = max(64, _round_up(max_out // max(1, probe_rel.size // chunk), 8)
                 + 64)
        tables = {name: grp.put_shared(table) for name, grp in groups.items()}
        outs, ratios["probe"] = run(
            probe_rel, self.PROBE_PAD_KEY,
            lambda name: partial(groups[name].launch(ht.probe_hash_table),
                                 table=tables[name], max_out=mo))
        out = concat_results([self.c.put_shared(r) for r in outs],
                             max_out=max_out)
        self.synchronize()
        t2 = time.perf_counter()
        timing.phase_s["probe"] = t2 - t1
        timing.wall_s = t2 - t0
        return out, timing, ratios

    # ------------------------------------------------------------------
    # PHJ.
    # ------------------------------------------------------------------
    def _partition_side_cooperative(self, tag: str, rel: Relation,
                                    sched: tuple[int, ...],
                                    partition_ratio: float, ctx,
                                    start_pass: int,
                                    timing: Timing) -> Relation:
        """Ratio-split partitioning, control back in Python between passes.

        ``ctx.check`` can abort at a pass boundary; on abort the current
        slices are collected into a partial layout via ``ctx.note_partial``
        and a re-admitted query resumes with ``start_pass`` = completed
        passes.  Each pass is a stable reorder over its own bit slice, so
        the result equals the whole-schedule path's.
        """
        slices = self._slices(rel, partition_ratio, timing)
        shift = sum(sched[:start_pass])

        def collect() -> Relation:
            return self._collect([r for _, r in slices])

        for i in range(start_pass, len(sched)):
            if ctx is not None:
                try:
                    ctx.check(f"partition:{tag}:pass{i}")
                except Exception:
                    if i > 0:
                        ctx.note_partial(tag, collect(), i)
                    raise
            bits = sched[i]
            slices = [(grp, grp.launch(partition_pass)(r, shift=shift,
                                                       bits=bits))
                      for grp, r in slices]
            shift += bits
        _maybe_fault("d2h")
        return collect()

    def phj(self, build_rel: Relation, probe_rel: Relation, *,
            bits_per_pass: int | None = None, num_passes: int | None = None,
            schedule: tuple[int, ...] | None = None, planner=None,
            shj_bits: int, max_out: int,
            partition_ratio: float, join_ratio: float,
            build_parts: Relation | None = None,
            probe_parts: Relation | None = None,
            parts_out: dict | None = None, ctx=None,
            build_resume: int | None = None,
            probe_resume: int | None = None
            ) -> tuple[ht.JoinResult, Timing]:
        """PHJ co-processing: ratio-split partitioning, then a partition-
        pair ownership split for the join phase (paper PHJ-DD/PL skeleton).

        Arguments as in ``repro.core.coprocess.PhjCoProcessorMixin.phj``:
        ``partition_ratio`` is the C share of the partition passes,
        ``join_ratio`` the fraction of partition pairs owned by C;
        ``build_parts``/``probe_parts`` are already-partitioned relations
        (skip their passes), ``parts_out`` receives freshly partitioned
        layouts, ``ctx`` makes partitioning preemptible at pass
        boundaries, and ``build_resume``/``probe_resume`` = k resume a
        partial layout that holds the schedule's first k passes.
        """
        timing = Timing(tracer=self.tracer)
        sched = resolve_schedule(build_rel.size, bits_per_pass=bits_per_pass,
                                 num_passes=num_passes, schedule=schedule,
                                 planner=planner)
        total_bits = sum(sched)
        timing.notes["schedule"] = list(sched)
        build_rel = self.pad_relation(build_rel, self.BUILD_PAD_KEY)
        probe_rel = self.pad_relation(probe_rel, self.PROBE_PAD_KEY)

        with timing.phase("partition", sync=self.synchronize,
                          passes=len(sched)):
            parts = {}
            if build_parts is not None and build_resume is None:
                parts["R"] = build_parts
                timing.notes["build_parts_reused"] = True
            if probe_parts is not None and probe_resume is None:
                parts["S"] = probe_parts
                timing.notes["probe_parts_reused"] = True
            todo = []
            for tag, rel, given, resume in (
                    ("R", build_rel, build_parts, build_resume),
                    ("S", probe_rel, probe_parts, probe_resume)):
                if tag in parts:
                    continue
                start = 0
                if given is not None and resume:
                    # A checkpointed partial layout: its first ``resume``
                    # passes are already absorbed.
                    rel, start = given, int(resume)
                    timing.notes[f"{tag}_resumed_at"] = start
                todo.append((tag, rel, start))
            for tag, rel, start in todo:
                # Each side's passes, device-timed on G's stream: ``rows``
                # the side's tuples, ``card_rows`` those of G's slice.
                with self.tracer.span(
                        PARTITION_SPANS[tag], device=self.g.device,
                        rows=rel.size,
                        card_rows=rel.size - self._cut(rel.size,
                                                       partition_ratio),
                        passes=len(sched) - start):
                    if ctx is not None or start:
                        parts[tag] = self._partition_side_cooperative(
                            tag, rel, sched, partition_ratio, ctx, start,
                            timing)
                    else:
                        pieces = [grp.launch(radix_partition_scheduled)(
                            r, schedule=sched).rel
                            for grp, r in self._slices(rel, partition_ratio,
                                                       timing)]
                        _maybe_fault("d2h")
                        parts[tag] = self._collect(pieces)
            if parts_out is not None:
                for tag, _, _ in todo:
                    parts_out[tag] = parts[tag]

        if ctx is not None:
            ctx.check("join")
        with timing.phase("join", sync=self.synchronize):
            out = self._join_owned(parts, total_bits, shj_bits, max_out,
                                   join_ratio, timing)
        timing.wall_s = timing.phase_s["partition"] + timing.phase_s["join"]
        return out, timing

    def _join_owned(self, parts: dict, total_bits: int, shj_bits: int,
                    max_out: int, join_ratio: float,
                    timing: Timing) -> ht.JoinResult:
        """Ownership exchange: partitions [0, own) -> C, the rest -> G.

        Each group's tuples are an ``owned_slice`` of the partitioned
        relation, selected on the device that holds it.
        """
        num_parts = 1 << total_bits
        own = self._cut(num_parts, join_ratio)
        pids = {tag: radix_of(parts[tag].key, shift=0, bits=total_bits)
                for tag in ("R", "S")}
        sentinels = {"R": self.BUILD_PAD_KEY, "S": self.PROBE_PAD_KEY}
        results = []
        for grp, lo, hi in ((self.c, 0, own), (self.g, own, num_parts)):
            if lo == hi:
                continue
            sub = {}
            for tag in ("R", "S"):
                rel, k = owned_slice(parts[tag], pids[tag], lo, hi, self.lcm,
                                     sentinels[tag])
                if self.discrete:
                    self._bus_delay(k * 8 // 2, timing)
                sub[tag] = grp.put_items(rel)
            # Full capacity per group: ownership is by radix value, so a
            # skewed relation's hot partition (and all its matches) can land
            # wholly on either side regardless of join_ratio.
            mo = _round_up(max_out, 8) + 64
            results.append(grp.launch(partitioned_join)(
                sub["R"], sub["S"], total_bits=total_bits, shj_bits=shj_bits,
                max_out=mo, tracer=self.tracer))
        _maybe_fault("d2h")
        if len(results) == 1:
            return results[0]
        return concat_results([self.c.put_shared(r) for r in results],
                              max_out=max_out)


def _time_once(grp: DeviceGroup, fn, *args) -> float:
    """Seconds of one call of ``fn`` on ``grp`` after one warm-up call,
    synchronized on both sides."""
    fn(*args)
    grp.synchronize()
    t0 = time.perf_counter()
    fn(*args)
    grp.synchronize()
    return time.perf_counter() - t0


def _pad_slice(rel: Relation, lo: int, hi: int, target: int,
               sentinel: int) -> Relation:
    """rel[lo:hi] padded with sentinel tuples up to ``target`` rows."""
    rid, key = rel.rid[lo:hi], rel.key[lo:hi]
    pad = target - (hi - lo)
    if pad <= 0:
        return Relation(rid, key)
    dev = rel.device
    return Relation(
        torch.cat([rid, torch.full((pad,), ht.INVALID, dtype=torch.int32,
                                   device=dev)]),
        torch.cat([key, torch.full((pad,), sentinel, dtype=torch.int32,
                                   device=dev)]))


def _concat_bucket_ranges(part_c: ht.HashTable, part_g: ht.HashTable,
                          own_c: int) -> ht.HashTable:
    """Stitch two bucket-range tables (on one device) into one table.

    C's table covers buckets [0, own_c) of the global space, G's covers
    [own_c, B).  G's key and rid indices shift past C's padded capacity.
    """
    nk_c = part_c.ukeys.shape[0]
    nr_c = part_c.rids.shape[0]
    return ht.HashTable(
        torch.cat([part_c.bucket_key_start[:own_c],
                   part_g.bucket_key_start[own_c:] + nk_c]),
        torch.cat([part_c.bucket_key_count[:own_c],
                   part_g.bucket_key_count[own_c:]]),
        torch.cat([part_c.ukeys, part_g.ukeys]),
        torch.cat([part_c.key_rid_start, part_g.key_rid_start + nr_c]),
        torch.cat([part_c.key_rid_count, part_g.key_rid_count]),
        torch.cat([part_c.rids, part_g.rids]),
        torch.cat([part_c.skeys, part_g.skeys]),
        part_c.num_keys + part_g.num_keys)
