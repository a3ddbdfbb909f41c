"""What the join service's spans say about a traced benchmark run, and
what the spans cost, on one CUDA card.

    python3 tools/trace_join_service.py --workload phj_paper_16m.repeat \
        --seed <n> [--seconds 51]
    python3 tools/trace_join_service.py --cost [--reps 2000]

With ``--workload`` it makes one traced run of a cell, as ``python3
bench/run.py --trace 1`` makes it, prints its result line, and then, from
the same run's spans and device trace, one JSON object:

* ``self_ms_without_new_spans``: ``service.self_ms`` read with the
  ``fingerprint``, ``fingerprint.*`` and ``lock_wait`` spans left out
  (the reader's meaning before those spans), against ``service.self_ms
  + table_cache.fingerprint_ms + service.lock_wait_ms``;
* ``join_device_ms``: the device time per execution of ``join.build``
  and ``join.probe``, and the two times the answered queries against
  the device's busy seconds in the profiler;
* ``partition_device_ms``: the device time per execution of each
  side's partition passes, ``partition.build`` and ``partition.probe``
  (0 for an execution that reused the side's layout);
* ``join_phase``: the profiler's operations inside the ``join`` phase
  spans (moved onto the host's clock), split into the join's own and
  the rest (copies to the host and random draws: the other client's
  fingerprint pull and inputs), against the two spans' device time;
* ``idle_s``: every idle gap of the card by the span open at it, and the
  share under ``admit`` and ``query``;
* ``span_names_in_device_ops``: program span names among the profiler's
  device operations (none is right).

With ``--cost`` it times the spans this tracing adds to one query of the
repeat cell (three ``fingerprint`` spans that hit the memo, one
``lock_wait``, and ``join.build`` and ``join.probe`` timed on the card,
resolved once the lock is released) and of the cold cell (two of the
fingerprints miss, with ``fingerprint.pull`` and ``fingerprint.hash``
inside), against the same loop with those spans on the no-op tracer:
microseconds per query, the median of five alternating runs of
``--reps`` queries.  Then the parts of a span alone (``current_stream``,
an event's ``record``, ``query`` and ``elapsed_time``, an untimed span),
and the repeat cell's loop under ``torch.profiler`` (CPU and CUDA
activities, as a traced benchmark run) on a thread it does not profile,
as the service's are.

Prints the card's name and power limit first.  Needs a CUDA card.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
NEW = ("fingerprint", "fingerprint.pull", "fingerprint.hash", "lock_wait")
STEPS = ("join.build", "join.probe")
PARTITION_SIDES = ("partition.build", "partition.probe")
# Operations on the card that the join phase does not launch.
FOREIGN = ("DtoH", "distribution")


def join_phase(r, steps) -> dict:
    """The profiler's operations inside the ``join`` phase spans, the
    join's own (by covered seconds) and the rest, against the device time
    of ``join.build`` plus ``join.probe``."""
    from bench.intervals import covered
    off = r.device.offset
    ops = sorted((a + off, b + off, n) for n, a, b in r.device.ops)
    starts = [a for a, _, _ in ops]
    own = other = 0.0
    for s in r.spans:
        if s.name != "join" or s.lane is not None:
            continue
        lo = bisect.bisect_left(starts, s.t0 - 1.0)
        inside = [o for o in ops[lo:bisect.bisect_right(starts, s.t1)]
                  if o[1] > s.t0]
        mine = [(a, b) for a, b, n in inside
                if not any(f in n for f in FOREIGN)]
        own += covered(mine, s.t0, s.t1)
        other += covered(((a, b) for a, b, n in inside), s.t0, s.t1) \
            - covered(mine, s.t0, s.t1)
    spans_s = sum(x.device_s for x in r.spans
                  if x.name in steps and x.device_s is not None)
    return {"own_ops_s": own, "other_ops_s": other,
            "build_plus_probe_device_s": spans_s,
            "spans_over_own": spans_s / own if own else None}


def traced_run(cell: str, seed: int, seconds: float) -> None:
    cache = ROOT / "bench" / "_cache"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(cache / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    from bench import harness
    from bench.spans import device_time, mean_ms, per_execution

    seen = []
    plain = harness.reader

    def reader(metric):
        read = plain(metric)

        def spy(r):
            seen.append(r)
            return read(r)
        return spy

    harness.reader = reader
    result = harness.run(cell, seed, seconds, True, t_start=T_START)
    print(json.dumps(result), flush=True)
    r = seen[0]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    without = plain("service.self_ms")(dataclasses.replace(
        r, spans=[s for s in r.spans if s.name not in NEW]))
    parts = sum(m.get(k, 0.0) for k in ("service.self_ms",
                                        "table_cache.fingerprint_ms",
                                        "service.lock_wait_ms"))
    steps = {name: mean_ms(per_execution(r.spans, (name,), device_time))
             for name in STEPS}
    sides = {name: mean_ms(per_execution(r.spans, (name,), device_time))
             for name in PARTITION_SIDES}
    join_s = (steps["join.build"] or 0.0) + (steps["join.probe"] or 0.0)
    join_s *= len(r.queries) / 1e3
    labels = [(s.name, s.t0, s.t1) for s in r.spans if s.lane is None]
    labels += [(f"bench.{k}", a, b) for q in r.queries
               for k, (a, b) in q.spans.items()]
    gaps = r.device.idle_gaps(labels, top=1 << 20)
    idle = sum(s for _, s in gaps)
    names = {s.name for s in r.spans}
    print(json.dumps({
        "self_ms_without_new_spans": without,
        "self_plus_fingerprint_plus_lock_wait_ms": parts,
        "identity_rel_diff": (parts - without) / without if without else None,
        "join_device_ms": steps,
        "partition_device_ms": sides,
        "answered": len(r.queries),
        "join_build_plus_probe_device_s": join_s,
        "device_busy_s": r.device.busy_s,
        "join_over_busy": (join_s / r.device.busy_s if r.device.busy_s
                           else None),
        "join_phase": join_phase(r, STEPS),
        "idle_s": gaps, "idle_total_s": idle,
        "idle_share_admit_query": (sum(s for n, s in gaps
                                       if n in ("admit", "query")) / idle
                                   if idle else None),
        "span_names_in_device_ops": sorted(
            names & {n for n, _, _ in r.device.ops}),
    }), flush=True)


def _us(fn, reps: int) -> float:
    """Microseconds per call of ``fn()``, the median of five runs."""
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        runs.append((time.perf_counter() - t0) / reps * 1e6)
    return statistics.median(runs)


def cost(reps: int) -> None:
    import torch
    from repro_torch.obs.trace import NULL_TRACER, Tracer
    card = torch.device("cuda", torch.cuda.current_device())
    x = torch.zeros(1024, device=card)
    tracer = Tracer()
    lock = threading.Lock()

    def fingerprint(tr, miss):
        with tr.span("fingerprint", side="build", memo="miss") as sp:
            if not miss:
                if sp is not None:
                    sp.set(memo="hit")
                return
            with tr.span("fingerprint.pull"):
                pass
            with tr.span("fingerprint.hash"):
                pass

    def query(tr, cold):
        with tracer.span("query", q_key=1):
            fingerprint(tr, cold)
            fingerprint(tr, False)
            fingerprint(tr, cold)
            with tr.span("lock_wait", group="G"):
                lock.acquire()
            with tr.span("join.build", device=card):
                x.add_(1)
            with tr.span("join.probe", device=card):
                for _ in range(3):
                    x.add_(1)
            torch.cuda.synchronize(card)
            lock.release()
        tr.resolve_device()

    def added(cold, n):
        """(null, traced) microseconds per query, alternating runs."""
        for tr in (NULL_TRACER, tracer):       # warm-up, and the pool
            for _ in range(50):
                query(tr, cold)
        runs = {"null": [], "traced": []}
        for _ in range(5):
            for key, tr in (("null", NULL_TRACER), ("traced", tracer)):
                t0 = time.perf_counter()
                for _ in range(n):
                    query(tr, cold)
                runs[key].append((time.perf_counter() - t0) / n * 1e6)
            tracer.clear()
        null, traced = (statistics.median(runs[k]) for k in runs)
        return {"us_per_query_null": null, "us_per_query_traced": traced,
                "us_per_query_added": traced - null, "runs_us": runs}

    out = {"repeat": added(False, reps), "cold": added(True, reps)}
    out["events_in_pool"] = sum(len(v) for v in tracer._events.values())

    # The parts of one span, alone.
    stream = torch.cuda.current_stream(card)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    a.record(stream)
    b.record(stream)
    torch.cuda.synchronize(card)

    def span():
        with tracer.span("x"):
            pass

    parts = {"current_stream": lambda: torch.cuda.current_stream(card),
             "event_record": lambda: a.record(stream),
             "event_query": b.query,
             "elapsed_time": lambda: a.elapsed_time(b),
             "span": span}
    with tracer.span("query", q_key=1):
        for name, fn in parts.items():
            out[f"{name}_us"] = _us(fn, reps)
            torch.cuda.synchronize(card)
            tracer.resolve_device()
            tracer.clear()

    # Under the profiler, as a traced benchmark run has it, on a thread
    # it does not profile.
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    box = {}
    with torch.profiler.profile(activities=acts):
        t = threading.Thread(
            target=lambda: box.update(r=added(False, reps // 4)))
        t.start()
        t.join()
    out["repeat_under_profiler"] = box["r"]
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=2**31 + 7)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--cost", action="store_true")
    ap.add_argument("--reps", type=int, default=2000)
    args = ap.parse_args()
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    if args.cost:
        cost(args.reps)
    if args.workload:
        traced_run(args.workload, args.seed, args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
