"""Where the time of the port's ``phj_join`` goes, on one CUDA card.

    python3 tools/profile_torch_phj.py [--n 16777216] [--trace-dir reports/torch]
    python3 tools/profile_torch_phj.py --paths [--n 16777216] [--reps 5]
    python3 tools/profile_torch_phj.py --csr [--n 16777216] [--reps 5]

Runs ``phj_join`` on two uniform relations of ``n`` tuples (seeds 1 and
2, the planner's schedule) and reports:

* a step breakdown from CUDA events: each partition pass of R and S, the
  final headers, and the join's bucket ids, build (b2 sorts, b3 key
  lists) and probe (the CSR lookup, then the scan and the expand), each
  timed alone after a warm-up;
* a ``torch.profiler`` trace of one whole ``phj_join``: device time per
  kernel name (top 15) and the device's busy share of the wall time
  (kernel time summed over the wall time; overlap would count twice, and
  the port runs on one stream).  The Chrome trace goes to
  ``<trace-dir>/phj_join_trace.json``.

With ``--paths`` it times instead the paths that run kernels E (radix
histogram) and F (partitioned probe), to compare two trees of the
repository in one call on one card: run it from each tree in turns
(parent, change, change, parent; a tree older than this mode needs this
file and ``src/repro_torch/obs/timing.py`` copied in).  Each number
comes after a warm-up call:

* the partitioned probe join, unique(n, seed 1) x uniform(n, seed 2) at
  13 bits: ``build_partitioned_table`` and ``probe``, one call each
  (``call_ms``, the median of ``--reps``);
* ``CoProcessor.groupby`` GPU_ONLY over the schedule (7, 6): n tuples
  with keys uniform in [0, n / 64) and full-range values
  (chip_smoke.py's group-by data), its phase times, the median of
  ``--reps`` calls;
* kernel E at n pids over 2^13 bins on its two inputs (the uniform pids
  that ``hash_bucket`` gives the probe join's packing, and the clustered
  pids of ``_headers`` after the (7, 6) schedule, which ``phj_join`` and
  the partitioned group-by give it) and kernel F at the probe join's
  layout: back to back (``cuda_ms``, 20 calls a run) and in a CUDA graph
  (``graph_ms``);
* ``phj_join``: one call (``call_ms``), then, last in the process, its
  device-busy time under the profiler.

With ``--csr`` it times the PHJ join phase's probe as the benchmark's
cells run it (one 13-bit pass, 9 bucket bits, ``max_out`` the service's
4 n + 1024, rounded up to 8, + 64) on two inputs: the uniform pair and a
Zipf-skewed S against a uniform R whose keys at three of S's ranks hold
4096 tuples each (``csr_probe.ref.zipf_pair``).  On each it checks the
CSR probe kernels against the plain steps p2 -> p3 -> p4, bit for bit,
and reports the plain steps' times (``call_ms``), the whole
``csr_probe_join`` back to back (``cuda_ms``) and in a CUDA graph, and
the profiler's device time per kernel of one call (lookup, the scan,
expand) beside their byte bounds.

Prints the card's name and power limit first and, with ``--paths`` or
``--csr``, a JSON object of every number last.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import repro_torch.ops  # noqa: E402,F401  (attaches CoProcessor.groupby)
from repro_torch.core import hash_table as ht  # noqa: E402
from repro_torch.core import (CoProcessor, Relation,  # noqa: E402
                              phj_bucket_count, phj_join, radix_of,
                              radix_partition_scheduled, resolve_schedule,
                              uniform_relation, unique_relation)
from repro_torch.core.partition import _headers, partition_pass  # noqa: E402
from repro_torch.core.phj import partition_bucket_ids  # noqa: E402
from repro_torch.kernels._build import build_all  # noqa: E402
from repro_torch.kernels.csr_probe import csr_probe as csr  # noqa: E402
from repro_torch.kernels.csr_probe import ref as csr_ref  # noqa: E402
from repro_torch.kernels.hash import hash as hsh  # noqa: E402
from repro_torch.kernels.partition_hist import partition_hist  # noqa: E402
from repro_torch.kernels.probe import ops as pops  # noqa: E402
from repro_torch.obs.timing import call_ms, cuda_ms, graph_ms  # noqa: E402

PROBE_BITS = 13
GROUP_SCHEDULE = (7, 6)


def breakdown(build, probe, sched, shj_bits, max_out) -> list[tuple]:
    rows = []
    rels = {"R": build, "S": probe}
    for tag in ("R", "S"):
        cur, shift = rels[tag], 0
        for i, bits in enumerate(sched):
            rows.append((f"partition {tag} pass{i} (bits {bits})", call_ms(
                lambda: partition_pass(cur, shift=shift, bits=bits))))
            cur = partition_pass(cur, shift=shift, bits=bits)
            shift += bits
        total = sum(sched)
        rows.append((f"partition {tag} final headers", call_ms(
            lambda: _headers(cur, total))))
        rels[tag] = cur
    r, s = rels["R"], rels["S"]
    total = sum(sched)
    nb = 1 << (total + shj_bits)
    rows.append(("join bucket ids R+S", call_ms(lambda: (
        partition_bucket_ids(r.key, total_bits=total, shj_bits=shj_bits),
        partition_bucket_ids(s.key, total_bits=total, shj_bits=shj_bits)))))
    bkt = partition_bucket_ids(r.key, total_bits=total, shj_bits=shj_bits)
    pbkt = partition_bucket_ids(s.key, total_bits=total, shj_bits=shj_bits)
    rows.append(("build b2 (two stable sorts)",
                 call_ms(lambda: ht.build_b2_order(bkt, r.key))))
    order = ht.build_b2_order(bkt, r.key)
    rows.append(("build b3 + b4 (key lists, rid gather)", call_ms(
        lambda: (ht.build_b3_keylists(bkt[order], r.key[order], nb),
                 ht.build_b4_ridlists(r.rid, order)))))
    table = ht.table_from_buckets(r, bkt, nb)
    rows.append(("probe lookup (p2 + p3)",
                 call_ms(lambda: csr.csr_lookup(table, pbkt, s.key))))
    entry, nmatch = csr.csr_lookup(table, pbkt, s.key)
    rows.append(("probe scan + expand (p4)", call_ms(
        lambda: csr.csr_expand(table, s.rid, entry, nmatch, max_out))))
    return rows


def _dev_us(e) -> float:
    return float(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)))


def device_profile(fn):
    """One call of ``fn`` under ``torch.profiler``: (the profile, its
    kernel rows by device time, the device-busy ms, the wall ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernel rows only: an aten op's row repeats its kernels' device time.
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=_dev_us, reverse=True)
    return prof, rows, sum(_dev_us(e) for e in rows) / 1e3, wall_ms


def profile(build, probe, max_out, trace_dir: Path) -> None:
    prof, rows, busy_ms, wall_ms = device_profile(
        lambda: phj_join(build, probe, max_out=max_out))
    trace_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_dir / "phj_join_trace.json"))
    print(f"profiled phj_join: wall {wall_ms:.3f} ms (host clock, under "
          f"the profiler), device busy {busy_ms:.3f} ms, busy share "
          f"{busy_ms / wall_ms:.3f}")
    for e in rows[:15]:
        print(f"  {_dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def paths(n: int, reps: int) -> dict:
    """The ``--paths`` numbers (see the module's docstring)."""
    build_all(("partition_hist_fused", "radix_scatter", "hash_bucket",
               "radix_hist", "partitioned_probe", "seg_agg"))
    out = {}
    build = uniform_relation(n, seed=1, device="cuda")
    probe = uniform_relation(n, seed=2, device="cuda")

    ubuild = unique_relation(n, seed=1, device="cuda")
    layout = pops.build_partitioned_table(ubuild, probe,
                                          total_bits=PROBE_BITS)
    out["build_partitioned_table_ms"] = call_ms(
        lambda: pops.build_partitioned_table(ubuild, probe,
                                             total_bits=PROBE_BITS), reps)
    out["probe_ms"] = call_ms(lambda: pops.probe(*layout[:3]), reps)

    rng = np.random.default_rng(n)
    keys = rng.integers(0, n // 64, n, dtype=np.int32)
    rng.integers(0, 100, n, dtype=np.int32)   # chip_smoke.py's small set
    vals = torch.from_numpy(rng.integers(-2**31, 2**31, n, dtype=np.int64)
                            .astype(np.int32)).cuda()
    rel = Relation(torch.arange(n, dtype=torch.int32, device="cuda"),
                   torch.from_numpy(keys).cuda())
    cp = CoProcessor(c_device="cpu", g_device="cuda")
    phases = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        _, t = cp.groupby(rel, vals, schedule=GROUP_SCHEDULE,
                          partition_ratio=0.0, agg_ratio=0.0)
        phases.append(t.phase_s)
    for name in phases[-1]:
        out[f"groupby_{name}_ms"] = statistics.median(
            p[name] * 1e3 for p in phases[1:])

    p = 1 << PROBE_BITS
    uniform = hsh.hash_bucket(build.key, num_buckets=p)
    parts = radix_partition_scheduled(build, schedule=GROUP_SCHEDULE).rel
    clustered = radix_of(parts.key, shift=0, bits=PROBE_BITS)
    for name, pid in (("uniform", uniform), ("clustered", clustered)):
        def run():
            return partition_hist.radix_hist(pid, num_parts=p)
        out[f"E_{name}_ms"] = cuda_ms(run, reps=20, warmup=3)
        out[f"E_{name}_graph_ms"] = graph_ms(run)
    out["F_ms"] = cuda_ms(lambda: pops.probe(*layout[:3]), reps=20, warmup=3)
    out["F_graph_ms"] = graph_ms(lambda: pops.probe(*layout[:3]))
    del ubuild, layout, rel, vals, parts

    max_out = 3 * n
    out["phj_join_ms"] = call_ms(
        lambda: phj_join(build, probe, max_out=max_out), reps)
    # Last: nothing else in the process runs after the profiler.
    out["phj_join_device_busy_ms"] = device_profile(
        lambda: phj_join(build, probe, max_out=max_out))[2]
    return out


HBM_BYTES_PER_S = 3.35e12


def csr_numbers(n: int, reps: int) -> dict:
    """The ``--csr`` numbers (see the module's docstring)."""
    build_all(("hash_bucket", "partition_hist_fused", "radix_scatter",
               "radix_hist", "csr_probe"))
    bits = PROBE_BITS
    shj_bits = max(0, phj_bucket_count(n, bits).bit_length() - 1)
    max_out = ((4 * n + 1024 + 7) // 8) * 8 + 64
    out = {"n": n, "bits": bits, "shj_bits": shj_bits, "max_out": max_out}
    for kind in ("uniform", "zipf"):
        r, s, table, pbkt = csr_ref.phj_probe_inputs(n, kind, (bits,),
                                                     device="cuda")
        entry, nmatch = csr.csr_lookup(table, pbkt, s.key)
        kstart, kcount = ht.probe_p2(table, pbkt)
        pentry, pnmatch = ht.probe_p3(table, s.key, kstart, kcount)
        got = csr.csr_probe_join(table, pbkt, s.key, s.rid, max_out)
        want = ht.probe_p4(table, s.rid, pentry, pnmatch, max_out)
        same = (torch.equal(entry, pentry) and torch.equal(nmatch, pnmatch)
                and all(torch.equal(getattr(got, f), getattr(want, f))
                        for f in ("probe_rid", "build_rid", "count")))
        res = {"bit_exact": same, "pairs": int(want.count),
               "max_rid_list": int(table.key_rid_count.max()),
               "max_nmatch": int(pnmatch.max())}
        del got, want, kstart, kcount, pentry, pnmatch
        res["plain_lookup_ms"] = call_ms(lambda: ht.probe_p3(
            table, s.key, *ht.probe_p2(table, pbkt)), reps)
        res["plain_expand_ms"] = call_ms(lambda: ht.probe_p4(
            table, s.rid, entry, nmatch, max_out), reps)

        def run():
            return csr.csr_probe_join(table, pbkt, s.key, s.rid, max_out)
        res["csr_probe_join_ms"] = cuda_ms(run, reps=20, warmup=3)
        res["csr_probe_join_graph_ms"] = graph_ms(run)
        _, rows, busy_ms, _ = device_profile(run)
        res["device_ms"] = busy_ms
        for e in rows:
            res[f"kernel_ms[{e.key[:60]}]"] = _dev_us(e) / 1e3
        for step, b in csr.probe_bytes(n, table.num_buckets, table.capacity,
                                       max_out).items():
            res[f"{step}_bound_ms"] = b / HBM_BYTES_PER_S * 1e3
        out[kind] = res
        print(kind, json.dumps(res), flush=True)
        del table, r, s, pbkt, entry, nmatch
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 24)
    ap.add_argument("--trace-dir", default="reports/torch")
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--csr", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_phj: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip())
    n = args.n
    if args.csr:
        out = csr_numbers(n, args.reps)
        print(json.dumps({"card": smi.stdout.strip(), **out}))
        return 0 if all(out[k]["bit_exact"] for k in ("uniform", "zipf")) \
            else 1
    if args.paths:
        print(f"tree {ROOT}", flush=True)
        out = paths(n, args.reps)
        for name, v in out.items():
            print(f"  {name}: {v:.5f}", flush=True)
        print(smi.stdout.strip())
        print(json.dumps({"card": smi.stdout.strip(), "tree": str(ROOT),
                          **out}))
        return 0
    build = uniform_relation(n, seed=1, device="cuda")
    probe = uniform_relation(n, seed=2, device="cuda")
    sched = resolve_schedule(n)
    shj_bits = max(0, phj_bucket_count(n, sum(sched)).bit_length() - 1)
    max_out = 3 * n
    print(f"n={n} schedule={sched} shj_bits={shj_bits} max_out={max_out}")
    wall = call_ms(lambda: phj_join(build, probe, max_out=max_out))
    print(f"phj_join: {wall:.3f} ms (CUDA events, median of 5)")
    rows = breakdown(build, probe, sched, shj_bits, max_out)
    for name, ms in rows:
        print(f"  {ms:9.3f} ms  {name}")
    print(f"  {sum(ms for _, ms in rows):9.3f} ms  sum of steps")
    profile(build, probe, max_out, Path(args.trace_dir))
    return 0


if __name__ == "__main__":
    sys.exit(main())
