"""Two-group co-processing executor: the PHJ schemes (§3.2).

Counterpart of the PHJ half of ``repro/core/coprocess.py``.  The paper's
CPU-GPU pair is a C group on the host CPU and a G group on the card
(``c_device="cpu"``, ``g_device="cuda:0"``); the JAX package emulates it
with two groups of one backend.  Both groups may be given the same
device, as tests do with ``"cpu"``.

``CoProcessor.phj`` splits the partition passes by ``partition_ratio``
(the C share of each relation's tuples) and the join phase by
``join_ratio`` (the C share of the partition pairs).  The C share runs the
kernels' plain versions on the host; the G share runs kernels A and B.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import torch

from . import hash_table as ht
from .cost_model import LinkSpec, ZEROCOPY_LINK
from .partition import partition_pass, radix_partition_scheduled
from .phj import partitioned_join, resolve_schedule
from .relation import Relation, radix_of, resolve_device
from .shj import concat_results


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
    """Executes PHJ across a C group and a G group."""

    BUILD_PAD_KEY = -2   # sentinel keys: pads never match real (>=0) keys
    PROBE_PAD_KEY = -3

    def __init__(self, c_device="cpu", g_device="cuda:0", *,
                 link: LinkSpec = ZEROCOPY_LINK, discrete: bool = False,
                 ratio_quantum: int = 64, tracer=None):
        from ..obs import NULL_TRACER
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.c = DeviceGroup("C", c_device)
        self.g = DeviceGroup("G", g_device)
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
                if ctx is not None or start:
                    parts[tag] = self._partition_side_cooperative(
                        tag, rel, sched, partition_ratio, ctx, start, timing)
                    continue
                pieces = [grp.launch(radix_partition_scheduled)(
                    r, schedule=sched).rel
                    for grp, r in self._slices(rel, partition_ratio, timing)]
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
                max_out=mo))
        _maybe_fault("d2h")
        if len(results) == 1:
            return results[0]
        return concat_results([self.c.put_shared(r) for r in results],
                              max_out=max_out)
