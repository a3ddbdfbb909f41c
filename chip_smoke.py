"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
sm_90a), holds each kernel bit for bit against its plain PyTorch version
at the main path's shapes and at ragged and wide ones, then drives the
port's main path, ``phj_join`` at 2^24 x 2^24 uniform tuples (the paper's
default size, §5.1), and ``CoProcessor.phj`` under GPU_ONLY and DD, each
verified against the NumPy sort-merge oracle.  The launch counts read
after the main path show that it went through the kernels.  Then it times
each kernel at the main path's shapes beside its bound, its plain version
and one PyTorch library call.

The second-to-last line is a JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``.  Any failed phase raises, and the
script exits non-zero without a result.  It also exits non-zero without a
CUDA device, or without the rest of the repository beside it.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import repro_torch.kernels as rk  # noqa: E402
from repro_torch.core import (CoProcessor, join_oracle, phj_join,  # noqa: E402
                              resolve_schedule, uniform_relation)
from repro_torch.kernels._build import build_all  # noqa: E402
from repro_torch.kernels.partition_hist import fused, reorder  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
N_MAIN = 1 << 24            # paper §5.1 default relation size
N_DD = 1 << 22
GRID_NS = (N_MAIN, 1_000_003, 4096)
GRID_BITS = (1, 6, 7, 13, 16)
GRID_SHIFTS = (0, 7)
KERNELS = {
    "partition_hist_fused": {
        "source": "src/repro_torch/csrc/partition_hist_fused.cu",
        "replaces": "src/repro/kernels/partition_hist/fused.py:57",
        "bytes_per_tuple": 8},
    "radix_scatter": {
        "source": "src/repro_torch/csrc/radix_scatter.cu",
        "replaces": "src/repro/kernels/partition_hist/reorder.py:67",
        "bytes_per_tuple": 20},
}


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` from CUDA events."""
    for _ in range(warmup):
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


def keys_for(n: int, dev, seed: int) -> torch.Tensor:
    """int32 keys over the whole range, with the negative pad sentinels."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64)
    keys[: min(n, 4)] = [-2, -3, -1, 2**31 - 1][: min(n, 4)]
    return torch.from_numpy(keys.astype(np.int32)).to(dev)


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def check_kernels(dev) -> dict[str, int]:
    """Phases 2-3: kernels A and B against their plain versions, bit for
    bit, over every n x bits x shift of the grid.  Returns the largest
    absolute difference seen per kernel (0 when bit-exact)."""
    err = {name: 0 for name in KERNELS}
    for n in GRID_NS:
        keys = keys_for(n, dev, seed=n)
        rng = np.random.default_rng(n + 1)
        rid = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
        for bits in GRID_BITS:
            for shift in GRID_SHIFTS:
                pid, hist = fused.partition_hist_fused(keys, shift=shift,
                                                       bits=bits)
                ppid, phist = fused.partition_hist_fused_plain(
                    keys, shift=shift, bits=bits)
                ea = max(max_abs_diff(pid, ppid), max_abs_diff(hist, phist))
                starts = torch.cumsum(hist, 0, dtype=torch.int32) - hist
                orid, okey = reorder.radix_scatter(rid, keys, pid, starts,
                                                   num_parts=1 << bits)
                prid, pkey = reorder.radix_scatter_plain(rid, keys, ppid)
                eb = max(max_abs_diff(orid, prid), max_abs_diff(okey, pkey))
                torch.cuda.synchronize()
                log(f"  n={n} bits={bits} shift={shift}: A err={ea} "
                    f"B err={eb}")
                assert ea == 0 and eb == 0, (n, bits, shift, ea, eb)
                err["partition_hist_fused"] = max(
                    err["partition_hist_fused"], ea)
                err["radix_scatter"] = max(err["radix_scatter"], eb)
    return err


def verify(res, exp: np.ndarray, what: str) -> None:
    """Count and sorted pairs equal to the oracle's ``exp``."""
    got = res.valid_pairs()
    assert int(res.count) == len(exp), (what, int(res.count), len(exp))
    assert got.shape == exp.shape and np.array_equal(got, exp), what
    log(f"  {what}: {len(exp)} matches, verified against the oracle")


def run_main_path(dev) -> dict:
    """Phase 4: phj_join at 2^24 x 2^24 with the planner's schedule."""
    build = uniform_relation(N_MAIN, seed=1, device=dev)
    probe = uniform_relation(N_MAIN, seed=2, device=dev)
    sched = resolve_schedule(N_MAIN)
    # max_out = 2n + matches, as examples/coprocess_join.py sizes it.
    exp = join_oracle(build, probe)
    max_out = 2 * N_MAIN + len(exp)
    log(f"  schedule {sched}, max_out {max_out}")
    phj_join(build, probe, max_out=max_out)          # warm-up
    torch.cuda.synchronize()
    rk.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = phj_join(build, probe, max_out=max_out)
    end.record()
    end.synchronize()
    counts = rk.launch_counts()
    wall_ms = start.elapsed_time(end)
    log(f"  phj_join wall {wall_ms:.3f} ms (CUDA events), launches {counts}")
    for name, c in counts.items():
        assert c > 0, f"main path never launched {name}"
    assert res.probe_rid.device.type == "cuda"
    verify(res, exp, "phj_join 2^24 x 2^24")
    return {"schedule": list(sched), "wall_ms": wall_ms, "launches": counts}


def run_coprocessor(dev) -> dict:
    """Phase 5: CoProcessor.phj, GPU_ONLY at 2^24 and DD at 2^22 (the C
    share runs the plain versions on the host CPU)."""
    cp = CoProcessor(c_device="cpu", g_device=dev)
    out = {}
    for scheme, n, pr, jr in (("GPU_ONLY", N_MAIN, 0.0, 0.0),
                              ("DD", N_DD, 0.25, 0.4)):
        build = uniform_relation(n, seed=1, device=dev)
        probe = uniform_relation(n, seed=2, device=dev)
        exp = join_oracle(build, probe)
        rk.reset_launch_counts()
        res, t = cp.phj(build, probe, shj_bits=2, max_out=2 * n + len(exp),
                        partition_ratio=pr, join_ratio=jr)
        counts = rk.launch_counts()
        log(f"  {scheme} n={n}: phases {t.phase_s}, launches {counts}")
        for name, c in counts.items():
            assert c > 0, f"{scheme} never launched {name}"
        verify(res, exp, f"CoProcessor.phj {scheme}")
        out[scheme] = {"n": n, "phase_s": t.phase_s, "launches": counts}
    return out


def time_kernels(dev, sched) -> dict[str, list]:
    """Phase 6: each kernel at the main path's passes (n = 2^24)."""
    rel = uniform_relation(N_MAIN, seed=1, device=dev)
    out = {name: [] for name in KERNELS}
    shift = 0
    for bits in sched:
        keys = rel.key
        pid, hist = fused.partition_hist_fused(keys, shift=shift, bits=bits)
        starts = torch.cumsum(hist, 0, dtype=torch.int32) - hist
        row_a = {
            "bits": bits, "shift": shift,
            "ms": cuda_ms(lambda: fused.partition_hist_fused(
                keys, shift=shift, bits=bits)),
            "plain_ms": cuda_ms(lambda: fused.partition_hist_fused_plain(
                keys, shift=shift, bits=bits)),
            "library_ms": cuda_ms(lambda: torch.bincount(
                pid, minlength=1 << bits))}
        row_b = {
            "bits": bits, "shift": shift,
            "ms": cuda_ms(lambda: reorder.radix_scatter(
                rel.rid, keys, pid, starts, num_parts=1 << bits)),
            "plain_ms": cuda_ms(lambda: reorder.radix_scatter_plain(
                rel.rid, keys, pid)),
            "library_ms": cuda_ms(lambda: (lambda o: (rel.rid[o], keys[o]))(
                torch.sort(pid, stable=True).indices))}
        for name, row in (("partition_hist_fused", row_a),
                          ("radix_scatter", row_b)):
            row["bound_ms"] = (KERNELS[name]["bytes_per_tuple"] * N_MAIN
                               / HBM_BYTES_PER_S * 1e3)
            out[name].append(row)
            log(f"  {name} bits={bits}: {row}")
        rel = type(rel)(*reorder.radix_scatter(rel.rid, keys, pid, starts,
                                               num_parts=1 << bits))
        shift += bits
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1] setup: {smi} | {kind} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build_all()
    log(f"  kernels built in {time.perf_counter() - t0:.1f} s")

    log("[2-3] kernels A and B against their plain versions (bit-exact)")
    err = check_kernels(dev)

    log("[4] main path: phj_join 2^24 x 2^24")
    main_path = run_main_path(dev)

    log("[5] CoProcessor.phj")
    run_coprocessor(dev)

    log("[6] kernel times at the main path's shapes")
    times = time_kernels(dev, main_path["schedule"])

    record = []
    for name, meta in KERNELS.items():
        first = times[name][0]
        record.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": main_path["launches"][name],
            "max_abs_err": err[name], "bit_exact": err[name] == 0,
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": "bytes",
            "library_ms": first["library_ms"], "per_pass": times[name]})
    log(smi)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
