"""Where the time of the port's ``phj_join`` goes, on one CUDA card.

    python3 tools/profile_torch_phj.py [--n 16777216] [--trace-dir reports/torch]

Runs ``phj_join`` on two uniform relations of ``n`` tuples (seeds 1 and
2, the planner's schedule) and reports:

* a step breakdown from CUDA events: each partition pass of R and S, the
  final headers, and the join's bucket ids, build (b2 sorts, b3 key
  lists) and probe (p2, p3, p4), each timed alone after a warm-up;
* a ``torch.profiler`` trace of one whole ``phj_join``: device time per
  kernel name (top 15) and the device's busy share of the wall time
  (kernel time summed over the wall time; overlap would count twice, and
  the port runs on one stream).  The Chrome trace goes to
  ``<trace-dir>/phj_join_trace.json``.

Prints the card's name and power limit first.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.core import hash_table as ht  # noqa: E402
from repro_torch.core import (phj_bucket_count, phj_join,  # noqa: E402
                              resolve_schedule, uniform_relation)
from repro_torch.core.partition import _headers, partition_pass  # noqa: E402
from repro_torch.core.phj import partition_bucket_ids  # noqa: E402


def cuda_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def breakdown(build, probe, sched, shj_bits, max_out) -> list[tuple]:
    rows = []
    rels = {"R": build, "S": probe}
    for tag in ("R", "S"):
        cur, shift = rels[tag], 0
        for i, bits in enumerate(sched):
            rows.append((f"partition {tag} pass{i} (bits {bits})", cuda_ms(
                lambda: partition_pass(cur, shift=shift, bits=bits))))
            cur = partition_pass(cur, shift=shift, bits=bits)
            shift += bits
        total = sum(sched)
        rows.append((f"partition {tag} final headers", cuda_ms(
            lambda: _headers(cur, total))))
        rels[tag] = cur
    r, s = rels["R"], rels["S"]
    total = sum(sched)
    nb = 1 << (total + shj_bits)
    rows.append(("join bucket ids R+S", cuda_ms(lambda: (
        partition_bucket_ids(r.key, total_bits=total, shj_bits=shj_bits),
        partition_bucket_ids(s.key, total_bits=total, shj_bits=shj_bits)))))
    bkt = partition_bucket_ids(r.key, total_bits=total, shj_bits=shj_bits)
    pbkt = partition_bucket_ids(s.key, total_bits=total, shj_bits=shj_bits)
    rows.append(("build b2 (two stable sorts)",
                 cuda_ms(lambda: ht.build_b2_order(bkt, r.key))))
    order = ht.build_b2_order(bkt, r.key)
    rows.append(("build b3 + b4 (key lists, rid gather)", cuda_ms(
        lambda: (ht.build_b3_keylists(bkt[order], r.key[order], nb),
                 ht.build_b4_ridlists(r.rid, order)))))
    table = ht.table_from_buckets(r, bkt, nb)
    rows.append(("probe p2 (bucket headers)",
                 cuda_ms(lambda: ht.probe_p2(table, pbkt))))
    kstart, kcount = ht.probe_p2(table, pbkt)
    rows.append(("probe p3 (binary search)", cuda_ms(
        lambda: ht.probe_p3(table, s.key, kstart, kcount))))
    entry, nmatch = ht.probe_p3(table, s.key, kstart, kcount)
    rows.append(("probe p4 (expand to pairs)", cuda_ms(
        lambda: ht.probe_p4(table, s.rid, entry, nmatch, max_out))))
    return rows


def profile(build, probe, max_out, trace_dir: Path) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  acc_events=True) as prof:
        t0 = time.perf_counter()
        phj_join(build, probe, max_out=max_out)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trace_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_dir / "phj_join_trace.json"))

    def dev_us(e) -> float:
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))

    # Kernel rows only: an aten op's row repeats its kernels' device time.
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    print(f"profiled phj_join: wall {wall_ms:.3f} ms (host clock, under "
          f"the profiler), device busy {busy_ms:.3f} ms, busy share "
          f"{busy_ms / wall_ms:.3f}")
    for e in rows[:15]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 24)
    ap.add_argument("--trace-dir", default="reports/torch")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_phj: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip())
    n = args.n
    build = uniform_relation(n, seed=1, device="cuda")
    probe = uniform_relation(n, seed=2, device="cuda")
    sched = resolve_schedule(n)
    shj_bits = max(0, phj_bucket_count(n, sum(sched)).bit_length() - 1)
    max_out = 3 * n
    print(f"n={n} schedule={sched} shj_bits={shj_bits} max_out={max_out}")
    wall = cuda_ms(lambda: phj_join(build, probe, max_out=max_out))
    print(f"phj_join: {wall:.3f} ms (CUDA events, median of 5)")
    rows = breakdown(build, probe, sched, shj_bits, max_out)
    for name, ms in rows:
        print(f"  {ms:9.3f} ms  {name}")
    print(f"  {sum(ms for _, ms in rows):9.3f} ms  sum of steps")
    profile(build, probe, max_out, Path(args.trace_dir))
    return 0


if __name__ == "__main__":
    sys.exit(main())
