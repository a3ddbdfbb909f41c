"""Deterministic, seed-driven fault injection for the execution path.

Resilience claims are only testable if failure is reproducible: this
module plants named *fault sites* through the engine — kernel launch,
H2D/D2H transfer, the worker loop, cache inserts — each a single
``maybe_fault(site)`` call that is a no-op branch when no injector is
installed.  A test (or the chaos section of ``slo_bench``) installs a
:class:`FaultInjector` whose per-site schedule is derived from one seed,
so the same seed always raises/delays/corrupts on the same calls.

Counterpart of ``repro/engine/faults.py``: the same schedules fire on the
same calls.  ``install`` plants the hook of ``repro_torch.core.coprocess``;
corruption and checksums read device columns through ``.cpu()``.

Modes per site:

  * ``raise``   — raise :class:`FaultInjected` (marked ``transient`` so
    the service's recovery ladder retries / degrades / falls back to the
    reference path instead of failing the query);
  * ``delay``   — sleep ``delay_s`` (a slow pass / stalled transfer);
  * ``corrupt`` — flag the call so the caller's ``maybe_corrupt`` hook
    flips payload bits (cache inserts: the checksum validation on reuse
    must catch it, never the query result).

Scheduling per site: explicit call numbers (``at``), a period
(``every``), or a seeded Bernoulli rate (``p``) — all 1-based on the
site's own call counter, optionally capped by ``max_faults``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
import time
import zlib

import numpy as np
import torch

#: Canonical site names (callers may use any string; these are the ones
#: the engine plants).
KERNEL = "kernel"            # DeviceGroup.launch'd step
H2D = "h2d"                  # DeviceGroup.put_items host-to-device
D2H = "d2h"                  # collection points of device results
WORKER = "worker"            # service worker loop (kills the thread)
CACHE_INSERT = "cache_insert"  # partition-layout / table cache puts

SITES = (KERNEL, H2D, D2H, WORKER, CACHE_INSERT)


class FaultInjected(RuntimeError):
    """An injected fault.  ``transient`` marks it retryable: the service's
    recovery ladder (retry -> degrade -> breaker -> reference path)
    engages for transient errors only — deterministic errors (bad query
    shapes etc.) still fail fast."""

    transient = True

    def __init__(self, site: str, nth: int):
        super().__init__(f"injected fault at site '{site}' (call #{nth})")
        self.site = site
        self.nth = nth


@dataclasses.dataclass
class FaultSpec:
    """Schedule for one site.  Any combination of triggers may be set;
    a call fires when any of them matches (subject to ``max_faults``)."""

    mode: str = "raise"            # "raise" | "delay" | "corrupt"
    at: tuple[int, ...] = ()       # explicit 1-based call numbers
    every: int | None = None       # every n-th call
    p: float = 0.0                 # seeded Bernoulli per call
    delay_s: float = 0.005         # sleep length for mode="delay"
    max_faults: int | None = None  # stop firing after this many


class FaultInjector:
    """Seed-deterministic fault scheduler over named sites.

    One ``random.Random`` per site (seeded from ``seed`` and the site
    name) drives the Bernoulli trigger, so sites fire independently but
    reproducibly regardless of call interleaving across threads.
    """

    def __init__(self, seed: int = 0, sites: dict[str, FaultSpec] | None
                 = None):
        self.seed = int(seed)
        self.sites = dict(sites or {})
        self._lock = threading.Lock()
        self._calls: dict[str, int] = {}
        self._fired: dict[str, int] = {}
        self._corrupt_pending: set[str] = set()
        # crc32, not hash(): str hashing is randomized per process, and
        # the whole point is the same seed firing on the same calls.
        self._rngs = {s: random.Random(self.seed ^ zlib.crc32(s.encode()))
                      for s in self.sites}

    def stats(self) -> dict:
        with self._lock:
            return {"calls": dict(self._calls), "fired": dict(self._fired)}

    def _decide(self, site: str) -> tuple[str | None, int, float]:
        """(mode-to-fire-or-None, call number, delay_s) for this call."""
        spec = self.sites.get(site)
        with self._lock:
            n = self._calls[site] = self._calls.get(site, 0) + 1
            if spec is None:
                return None, n, 0.0
            fired = self._fired.get(site, 0)
            if spec.max_faults is not None and fired >= spec.max_faults:
                return None, n, 0.0
            hit = (n in spec.at
                   or (spec.every and n % spec.every == 0)
                   or (spec.p > 0.0
                       and self._rngs[site].random() < spec.p))
            if not hit:
                return None, n, 0.0
            self._fired[site] = fired + 1
            if spec.mode == "corrupt":
                self._corrupt_pending.add(site)
            return spec.mode, n, spec.delay_s

    def visit(self, site: str) -> None:
        mode, n, delay_s = self._decide(site)
        if mode == "raise":
            raise FaultInjected(site, n)
        if mode == "delay":
            time.sleep(delay_s)
        # "corrupt" arms the site; the caller's maybe_corrupt consumes it.

    def take_corrupt(self, site: str) -> bool:
        """Consume a pending corruption for ``site`` (armed by visit)."""
        with self._lock:
            if site in self._corrupt_pending:
                self._corrupt_pending.discard(site)
                return True
            return False


# Module-level installed injector: ``maybe_fault`` must cost one load and
# one branch on the hot path when inactive.
_injector: FaultInjector | None = None


def install(injector: FaultInjector | None) -> None:
    global _injector
    _injector = injector
    # Plant (or clear) the core-layer hook.  ``core.coprocess`` must not
    # import the engine package, so the binding runs in this direction:
    # the hook slot is a module global the core layer reads per call.
    from ..core import coprocess
    coprocess._FAULT_HOOK = maybe_fault if injector is not None else None


def active() -> bool:
    return _injector is not None


def current() -> FaultInjector | None:
    return _injector


def maybe_fault(site: str) -> None:
    """The hook planted at every fault site (no-op when uninstalled)."""
    inj = _injector
    if inj is None:
        return
    inj.visit(site)


def maybe_corrupt(site: str, rel):
    """Return ``rel`` (a Relation-like with int ``key``/``rid`` columns),
    corrupted when the site's injector armed a corruption on this call.
    The corruption flips key values — a stored partition layout that no
    longer matches its checksum, which the service's validation on reuse
    must detect and treat as a cache miss."""
    inj = _injector
    if inj is None or not inj.take_corrupt(site):
        return rel
    key = rel.key.cpu().numpy().copy()
    if key.size:
        idx = random.Random(inj.seed ^ key.size).randrange(key.size)
        key[idx] = np.int32(np.bitwise_xor(np.int64(key[idx]), 0x55) &
                            0x7fffffff)
    return type(rel)(rel.rid, torch.from_numpy(key).to(rel.key.device))


@contextlib.contextmanager
def injected(injector: FaultInjector):
    """Install ``injector`` for the duration of a with-block."""
    prev = _injector
    install(injector)
    try:
        yield injector
    finally:
        install(prev)


def layout_checksum(rel) -> int:
    """Cheap content checksum of a partition layout (key + rid columns).
    Only computed when an injector is active — normal serving never pays
    the D2H pull this forces on device-resident layouts."""
    key = rel.key.cpu().numpy().astype(np.int64)
    rid = rel.rid.cpu().numpy().astype(np.int64)
    return int((key.sum() * 1000003 + rid.sum()) & 0x7fffffffffffffff)
