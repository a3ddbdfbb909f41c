"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's eight CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
sm_90a, one process per source, all at once) and holds each integer kernel
bit for bit against its plain PyTorch version at the main paths' shapes and
at ragged and wide ones: A (n1+n2), B (n3), C (segmented aggregation),
D (hash bucket) and E (radix histogram), with A, B and E also at digits of
17 and 18 bits (past the planner's 16), A at 1-3 bits on ragged and
unaligned keys, E on clustered pids (sorted runs with out-of-range pids
inside them, ragged, unaligned, up to 2^17 bins), and ``phj_join`` over
the pass schedules (17,) and (9, 9) at 2^20 against the join oracle.  Then it drives the port's
main paths, each with the launch counts set to 0 just before it and read
just after, and verifies each against a NumPy oracle:

* the join: ``phj_join`` at 2^24 x 2^24 uniform tuples (the paper's
  default size, §5.1) and ``CoProcessor.phj`` under GPU_ONLY and DD;
* the group-by: ``CoProcessor.groupby`` over 2^24 tuples with 2^18
  uniform group keys, GPU_ONLY unpartitioned and partitioned, and DD
  partitioned and separate at 2^22 (the C share on the host CPU);
* the partitioned probe join (kernel F): ``build_partitioned_table`` and
  ``probe`` over 2^24 unique x 2^24 uniform tuples at 13 radix bits;
* the co-processed SHJ: ``CoProcessor.shj`` GPU_ONLY at 2^24, CPU_ONLY,
  DD and PL in both table modes and DD discrete at 2^22,
  ``basic_unit_shj`` at 2^22, and the semi / anti / left-outer probes of
  ``probe_table_variant`` (GPU_ONLY at 2^24, DD at 2^22).

* the LM serving path: Zamba2-1.2B at full width and depth (38 layers,
  d_model 2048, bf16, random weights from seed 0) through
  ``ServeEngine.generate`` for 4 prompts x 2048 tokens + 32 new and
  2 x 1000 + 16, with 6 launches of kernel G (flash attention) and 32 of
  kernel H (SSD intra-chunk) per generate, all in the prefill; the decode
  logits held against ``forward_train`` (which runs G and H) within
  tests/test_archs.py's 0.06 relative limit.

Kernel F (partitioned probe) is held against its plain version first,
like A-E, on sorted and on permuted rows (K from 1 to 2^20) and on
``build_partitioned_table``'s rows of negative build keys, and again at
2^17 partitions after the probe join; G and H
against theirs within tests/test_kernels.py's tolerances over their
grids in float32 and bfloat16 (H's bfloat16 cases through its
tensor-core variant and through its CUDA-core variant, which serves
float32), and on one attention block's and one Mamba2 block's
activations from the Zamba2 prefill, whose 32 H launches the
tensor-core variant must all serve.  Then the script times each kernel at the main paths' shapes
beside its bound, its plain version and one PyTorch library call (or a
composite of them), with CUDA events around launches enqueued back to
back.  G (wgmma + TMA at head_dim 64 and 128) is timed at the Zamba2
shape and at a Qwen3-8B-shaped GQA shape against SDPA, with the variant
that served it; B (the shared-memory tile reorder) at both passes of the
join's (7, 6) schedule against a stable sort and two gathers; A (wide
loads, per-warp sub-histograms) there too against ``torch.bincount``;
H (wgmma + TMA) at the Zamba2 prefill shape, with its CUDA-core
variant's time beside it; E (wide loads, runs merged before the atomic)
on the uniform pids of the probe join's packing (the record's row) and on
the clustered pids of the final headers (beside it, under ``per_input``);
F (a TMA ring, a producer warp, six consumer groups) at the probe join's
layout.  E and F are also timed in a CUDA graph (``graph_ms``), the
device's time without the host's per-call work.

The second-to-last line is a JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``.  Any failed phase raises, and the
script exits non-zero without a result.  It also exits non-zero without a
CUDA device, or without the rest of the repository beside it.
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import repro_torch.kernels as rk  # noqa: E402
import repro_torch.ops  # noqa: E402,F401  (attaches CoProcessor.groupby)
from repro_torch.core import (PCIE_LINK, CoProcessor,  # noqa: E402
                              Relation, join_oracle, phj_join,
                              radix_partition_scheduled, radix_of,
                              resolve_schedule, uniform_relation,
                              unique_relation)
from repro_torch.core.coprocess import owned_slice  # noqa: E402
from repro_torch.kernels._build import build_all  # noqa: E402
from repro_torch.kernels.agg import agg  # noqa: E402
from repro_torch.kernels.hash import hash as hsh  # noqa: E402
from repro_torch.kernels.partition_hist import (  # noqa: E402
    fused, partition_hist, reorder)
from repro_torch.kernels.partition_hist.ref import (  # noqa: E402
    clustered_pids)
from repro_torch.kernels.probe import ops as pops  # noqa: E402
from repro_torch.kernels.probe import probe as pprobe  # noqa: E402
from repro_torch.kernels.probe.ref import (  # noqa: E402
    probe_ref, random_layout)
from repro_torch.ops import groupby as gb  # noqa: E402
from repro_torch.ops import join_variants as jv  # noqa: E402
import repro_torch.layers.attention as lattn  # noqa: E402
import repro_torch.layers.ssd as lssd  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attn import flash_attn as fa  # noqa: E402
from repro_torch.kernels.ssd import ssd as kssd  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.obs.timing import cuda_ms, graph_ms  # noqa: E402
from repro_torch.serve.engine import (ServeEngine,  # noqa: E402
                                      grow_cache, make_decode_step,
                                      make_prefill_step)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak
N_MAIN = 1 << 24            # paper §5.1 default relation size
N_DD = 1 << 22
GRID_NS = (N_MAIN, 1_000_003, 4096)
GRID_BITS = (1, 6, 7, 13, 16)
GRID_SHIFTS = (0, 7)
GRID_BUCKETS = (1, 1 << 7, 1 << 13, 1 << 31)
GRID_PARTS = (2, 1 << 7, 1 << 13, 1 << 16)
# Digits wider than 16 bits (a pass schedule the reference takes past the
# planner's 16), narrow digits and ragged or unaligned key vectors.
N_WIDE = 1 << 20
WIDE_BITS = (17, 18)
NARROW_BITS = (1, 2, 3)
WIDE_SCHEDULES = ((17,), (9, 9))
WIDE_PROBE_BITS = 17
JOIN_KERNELS = ("partition_hist_fused", "radix_scatter", "hash_bucket",
                "radix_hist")
KERNELS = {
    "partition_hist_fused": {
        "source": "src/repro_torch/csrc/partition_hist_fused.cu",
        "replaces": "src/repro/kernels/partition_hist/fused.py:57",
        "bytes_per_tuple": 8},
    "radix_scatter": {
        "source": "src/repro_torch/csrc/radix_scatter.cu",
        "replaces": "src/repro/kernels/partition_hist/reorder.py:67",
        "bytes_per_tuple": 20},
    "seg_agg": {
        "source": "src/repro_torch/csrc/seg_agg.cu",
        "replaces": "src/repro/kernels/agg/agg.py:120"},
    "hash_bucket": {
        "source": "src/repro_torch/csrc/hash_bucket.cu",
        "replaces": "src/repro/kernels/hash/hash.py:31"},
    "radix_hist": {
        "source": "src/repro_torch/csrc/radix_hist.cu",
        "replaces": "src/repro/kernels/partition_hist/partition_hist.py:32"},
    "partitioned_probe": {
        "source": "src/repro_torch/csrc/partitioned_probe.cu",
        "replaces": "src/repro/kernels/probe/probe.py:54"},
    "flash_attn": {
        "source": "src/repro_torch/csrc/flash_attn.cu",
        "replaces": "src/repro/kernels/flash_attn/flash_attn.py:65"},
    "ssd_intra_chunk": {
        "source": "src/repro_torch/csrc/ssd_intra_chunk.cu",
        "replaces": "src/repro/kernels/ssd/ssd.py:40"},
}
LM_ARCH = "zamba2_1_2b"     # the one config whose serving runs G and H
# (batch, prompt, new tokens) of the two served batches: multiples of 128
# and 256, then a ragged prompt (G's tail and ssd_chunked's padding).
LM_BATCHES = ((4, 2048, 32), (2, 1000, 16))
LM_REL_LIMIT = 0.06         # tests/test_archs.py:83
# Kernel G's grid (B, Sq, Sk, H, KV, D, causal): tests/test_kernels.py:92-97,
# Zamba2's prefill, a Qwen3-8B-shaped GQA case, D = 96 and a ragged length.
GRID_G = ((2, 256, 256, 4, 2, 64, True), (1, 128, 384, 8, 8, 128, False),
          (2, 256, 256, 4, 4, 32, True), (1, 256, 256, 8, 2, 64, True),
          (4, 2048, 2048, 32, 32, 64, True), (1, 2048, 2048, 32, 8, 128, True),
          (1, 1024, 1024, 32, 32, 96, True), (1, 1000, 1000, 8, 2, 64, True))
# Kernel H's grid (B, NC, Q, H, P, N): tests/test_kernels.py:114-116,
# Zamba2's prefill, Mamba2-2.7B's state width and a ragged chunk.
GRID_H = ((2, 3, 64, 4, 32, 16), (1, 2, 128, 8, 64, 64),
          (1, 2, 128, 4, 64, 128), (4, 8, 256, 64, 64, 64),
          (1, 4, 256, 80, 64, 128), (2, 1, 37, 64, 64, 64))
TOL_G = {torch.float32: 3e-5, torch.bfloat16: 2e-2}   # test_kernels.py:109
TOL_H = {torch.float32: 2e-4, torch.bfloat16: 3e-2}   # test_kernels.py:128
PROBE_BITS = 13             # the planner's (7, 6) schedule at 2^24
# (P, K, M) of kernel F's check, each on sorted and on permuted rows:
# P in {1, 16, 2^13} x K in {1, 8, 36, 37, 2304}, a row past the 48 KB
# default of shared memory, and one longer than shared memory holds at all
# (searched in device memory).  K = 37 and 1 take the one-block-per-row
# kernel (rows off 16 bytes), the others with K <= 2304 the TMA ring.
GRID_PROBE = ((1, 8, 8), (16, 8, 300), (8192, 8, 128), (16, 1, 300),
              (64, 36, 129), (64, 37, 129), (1, 2304, 5000),
              (16, 2304, 2304), (8192, 2304, 2304), (16, 32768, 4096),
              (1, 1 << 20, 1 << 16))
# Kernel E's clustered check: sorted runs with out-of-range pids inside,
# ragged n, P up to 2^17, aligned and 4 bytes past (phase 6 checks both
# of its inputs at 2^24 too).
E_CLUSTER_NS = (1, 3, 4099, N_WIDE + 3)
E_CLUSTER_PARTS = (1, 2, 1 << 13, 1 << 14, 1 << 17)


def log(*a):
    print(*a, flush=True)


T_START = time.perf_counter()


def log_phase(label: str) -> None:
    log(f"{label} (at {time.perf_counter() - T_START:.1f} s)")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def check_wide_kernels(dev) -> dict[str, int]:
    """Phases 2-3, continued: A, B and E at digits of 17 and 18 bits
    (2^17 and 2^18 partitions: A's and E's global histograms, B's
    device-memory cursors) at n = 2^20, shifts 0 and 7; A at narrow digits
    (1-3 bits) on a ragged n and on keys that start 4 bytes past an
    aligned address (its scalar path); all bit for bit."""
    err = {"partition_hist_fused": 0, "radix_scatter": 0, "radix_hist": 0}
    keys = keys_for(N_WIDE, dev, seed=17)
    rid = torch.arange(N_WIDE, dtype=torch.int32, device=dev)
    for bits in WIDE_BITS:
        for shift in GRID_SHIFTS:
            pid, hist = fused.partition_hist_fused(keys, shift=shift,
                                                   bits=bits)
            ppid, phist = fused.partition_hist_fused_plain(keys, shift=shift,
                                                           bits=bits)
            ea = max(max_abs_diff(pid, ppid), max_abs_diff(hist, phist))
            ee = max_abs_diff(partition_hist.radix_hist(pid,
                                                        num_parts=1 << bits),
                              phist)
            starts = torch.cumsum(hist, 0, dtype=torch.int32) - hist
            got = reorder.radix_scatter(rid, keys, pid, starts,
                                        num_parts=1 << bits)
            want = reorder.radix_scatter_plain(rid, keys, ppid)
            eb = max(max_abs_diff(a, b) for a, b in zip(got, want))
            torch.cuda.synchronize()
            log(f"  n={N_WIDE} bits={bits} shift={shift}: A err={ea} B err={eb} "
                f"E err={ee} (B on {reorder.tile_len(1 << bits)}-tuple "
                "tiles, device memory)")
            assert ea == eb == ee == 0, (bits, shift, ea, eb, ee)
    for n in (N_WIDE + 3, 5):
        base = keys_for(n + 1, dev, seed=n)
        for bits in NARROW_BITS:
            for name, k in (("aligned", base[:n]), ("offset", base[1:])):
                got = fused.partition_hist_fused(k, shift=7, bits=bits)
                want = fused.partition_hist_fused_plain(k, shift=7, bits=bits)
                ea = max(max_abs_diff(a, b) for a, b in zip(got, want))
                torch.cuda.synchronize()
                assert ea == 0, ("narrow", n, bits, name, ea)
        log(f"  n={n} bits 1-3, aligned and offset keys: A err=0")
    return err


def run_wide_joins(dev) -> None:
    """Phases 2-3, continued: ``phj_join`` over pass schedules past 16
    bits, uniform(2^20, seed 1) x uniform(2^20, seed 2), against the
    join oracle."""
    build = uniform_relation(N_WIDE, seed=1, device=dev)
    probe = uniform_relation(N_WIDE, seed=2, device=dev)
    exp = uniform_oracle(N_WIDE)
    for sched in WIDE_SCHEDULES:
        rk.reset_launch_counts()
        res = phj_join(build, probe, schedule=sched,
                       max_out=2 * N_WIDE + len(exp))
        counts = rk.launch_counts()
        for name in ("partition_hist_fused", "radix_scatter", "radix_hist"):
            assert counts[name] > 0, (sched, name, counts)
        verify(res, exp, f"phj_join 2^20 x 2^20, schedule {sched}")


def check_group_kernels(dev) -> dict[str, int]:
    """Phases 2-3, continued: kernels C, D and E against their plain
    versions, bit for bit, over n x (S, wrap32, gid order) for C, n x B
    for D and n x P for E, with negative keys, gids -1 and >= S, and pids
    outside [0, P).  Returns the largest absolute difference per kernel."""
    err = {"seg_agg": 0, "hash_bucket": 0, "radix_hist": 0}
    for n in GRID_NS:
        rng = np.random.default_rng(n + 2)
        keys = keys_for(n, dev, seed=n + 3)
        val = torch.from_numpy(rng.integers(-2**31, 2**31, n, dtype=np.int64)
                               .astype(np.int32)).to(dev)
        for b in GRID_BUCKETS:
            e = max_abs_diff(hsh.hash_bucket(keys, num_buckets=b),
                             hsh.hash_bucket_plain(keys, num_buckets=b))
            err["hash_bucket"] = max(err["hash_bucket"], e)
            assert e == 0, ("hash_bucket", n, b, e)
        for p in GRID_PARTS:
            pid = torch.from_numpy(rng.integers(-2, p + 2, n)
                                   .astype(np.int32)).to(dev)
            e = max_abs_diff(partition_hist.radix_hist(pid, num_parts=p),
                             partition_hist.radix_hist_plain(pid,
                                                             num_parts=p))
            err["radix_hist"] = max(err["radix_hist"], e)
            assert e == 0, ("radix_hist", n, p, e)
        for slots in (1, 1000, n):
            unsorted = torch.from_numpy(rng.integers(-1, slots + 2, n)
                                        .astype(np.int32)).to(dev)
            for order, gid in (("unsorted", unsorted),
                               ("sorted", torch.sort(unsorted).values)):
                for wrap32 in (False, True):
                    got = agg.seg_agg(gid, val, num_slots=slots,
                                      wrap32=wrap32)
                    want = agg.seg_agg_plain(gid, val, num_slots=slots,
                                             wrap32=wrap32)
                    e = max(max_abs_diff(a, b) for a, b in zip(got, want))
                    torch.cuda.synchronize()
                    err["seg_agg"] = max(err["seg_agg"], e)
                    assert e == 0, ("seg_agg", n, slots, order, wrap32, e)
                    if not wrap32:
                        log(f"  n={n} S={slots} {order}: C err={e} "
                            f"(sum rows {got[1].shape[0]})")
        log(f"  n={n}: D err={err['hash_bucket']} E err={err['radix_hist']}")
    return err


@functools.lru_cache(maxsize=None)
def uniform_oracle(n: int) -> np.ndarray:
    """``join_oracle`` of uniform(n, seed 1) x uniform(n, seed 2), once per
    n: phases 4, 5 and 8 join the same relations."""
    return join_oracle(uniform_relation(n, seed=1, device="cpu"),
                       uniform_relation(n, seed=2, device="cpu"))


def phase_ms(t) -> dict:
    """A ``Timing``'s phase seconds as milliseconds, for the log."""
    return {k: round(v * 1e3, 3) for k, v in t.phase_s.items()}


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
    exp = uniform_oracle(N_MAIN)
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
    for name in JOIN_KERNELS:
        assert counts[name] > 0, f"main path never launched {name}"
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
        exp = uniform_oracle(n)
        rk.reset_launch_counts()
        res, t = cp.phj(build, probe, shj_bits=2, max_out=2 * n + len(exp),
                        partition_ratio=pr, join_ratio=jr)
        counts = rk.launch_counts()
        log(f"  {scheme} n={n}: phases {t.phase_s}, launches {counts}")
        for name in JOIN_KERNELS:
            assert counts[name] > 0, f"{scheme} never launched {name}"
        verify(res, exp, f"CoProcessor.phj {scheme}")
        out[scheme] = {"n": n, "phase_s": t.phase_s, "launches": counts}
    return out


def group_data(n: int, seed: int):
    """Group keys uniform in [0, n/64) and two value sets: uniform in
    [0, 100) and full-range int32 (exact wide sums), made with NumPy."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n // 64, n, dtype=np.int32)
    small = rng.integers(0, 100, n, dtype=np.int32)
    full = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    return keys, {"small": small, "full": full}


def group_oracle(keys: np.ndarray, vals: np.ndarray):
    """Vectorized group-by oracle: sort + reduceat, exact int64 sums."""
    o = np.argsort(keys, kind="stable")
    sk, sv = keys[o], vals[o].astype(np.int64)
    starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
    return (sk[starts], np.diff(np.r_[starts, sk.shape[0]]),
            np.add.reduceat(sv, starts), np.minimum.reduceat(sv, starts),
            np.maximum.reduceat(sv, starts))


def verify_groups(res, exp, what: str) -> None:
    got = res.sorted()
    assert res.num_groups == exp[0].shape[0], (what, res.num_groups)
    for name, g, e in zip(("keys", "counts", "sums", "mins", "maxs"),
                          (got.keys, got.counts, got.sums, got.mins,
                           got.maxs), exp):
        assert np.array_equal(g.astype(np.int64), e.astype(np.int64)), \
            (what, name)
    assert got.sums.dtype == np.int64


def agg_steps_ms(dev, rel: Relation, vals: torch.Tensor, sched) -> dict:
    """The GPU_ONLY partitioned group-by's agg phase, step by step, each
    step timed with CUDA events after a warm-up."""
    parts = radix_partition_scheduled(rel, schedule=sched).rel
    total_bits = sum(sched)
    steps = {}

    def timed(name, fn):
        steps[name] = cuda_ms(fn, reps=5, warmup=1)
        return fn()

    pid = timed("owner pids (D)",
                lambda: radix_of(parts.key, shift=0, bits=total_bits))
    sub, _ = timed("owned select", lambda: owned_slice(
        parts, pid, 0, 1 << total_bits, 1, gb.GROUP_PAD_KEY))
    v = timed("gather values", lambda: gb._gather_values(vals, sub.rid))
    order = timed("sort", lambda: torch.sort(
        sub.key ^ agg.INT32_MIN, stable=True).indices)
    skey = sub.key[order]

    def slot_ids():
        first = torch.ones(sub.size, dtype=torch.bool, device=dev)
        first[1:] = skey[1:] != skey[:-1]
        gid = (torch.cumsum(first, 0, dtype=torch.int32) - 1).to(
            torch.int32)
        ukeys = torch.full((sub.size,), gb.GROUP_PAD_KEY, dtype=torch.int32,
                           device=dev)
        ukeys[gid.to(torch.int64)] = skey
        return gid, ukeys

    gid, ukeys = timed("slot ids", slot_ids)
    out = timed("C (seg_agg)", lambda: agg.seg_agg(
        gid, v[order], num_slots=sub.size))
    timed("collect", lambda: gb._collect([(ukeys, *out, None)],
                                         wrap32=False))
    return steps


def run_groupby(dev) -> dict:
    """Phase 5b: the group-by main path, CoProcessor.groupby, GPU_ONLY
    unpartitioned and partitioned at 2^24 (after one warm-up call each),
    DD partitioned and separate at 2^22, each with both value sets,
    verified against the oracle."""
    cp = CoProcessor(c_device="cpu", g_device=dev)
    out = {}
    for n, runs in ((N_MAIN, (("GPU_ONLY", None, 0.0, 0.0),
                              ("GPU_ONLY_PART", resolve_schedule(N_MAIN),
                               0.0, 0.0))),
                    (N_DD, (("DD_PART", resolve_schedule(N_DD), 0.25, 0.4),
                            ("DD_SEPARATE", None, 0.25, 0.25)))):
        keys, value_sets = group_data(n, seed=n)
        rel = Relation(torch.arange(n, dtype=torch.int32, device=dev),
                       torch.from_numpy(keys).to(dev))
        if n == N_MAIN:
            # One untimed call per scheme first, as phase 4 warms up
            # phj_join: the first call pays the allocator's growth.
            warm = torch.from_numpy(value_sets["full"]).to(dev)
            for scheme, sched, pr, ar in runs:
                _, t = cp.groupby(rel, warm, schedule=sched,
                                  partition_ratio=pr, agg_ratio=ar)
                log(f"  warm-up {scheme}: phases {phase_ms(t)} ms")
        for vname, vals in value_sets.items():
            exp = group_oracle(keys, vals)
            tvals = torch.from_numpy(vals).to(dev)
            for scheme, sched, pr, ar in runs:
                torch.cuda.synchronize()
                rk.reset_launch_counts()
                res, t = cp.groupby(rel, tvals, schedule=sched,
                                    partition_ratio=pr, agg_ratio=ar)
                counts = rk.launch_counts()
                what = f"groupby {scheme} n={n} values={vname}"
                log(f"  {what}: schedule {sched}, phases "
                    f"{phase_ms(t)}"
                    f" ms, merge {t.merge_s * 1e3:.3f} ms, "
                    f"{res.num_groups} groups, launches {counts}")
                need = (("seg_agg",) if sched is None else
                        ("seg_agg",) + JOIN_KERNELS)
                for name in need:
                    assert counts[name] > 0, f"{what} never launched {name}"
                verify_groups(res, exp, what)
                out[f"{scheme}/{vname}"] = {
                    "n": n, "schedule": list(sched or ()),
                    "phase_ms": {k: v * 1e3 for k, v in t.phase_s.items()},
                    "launches": counts}
        if n == N_MAIN:
            steps = agg_steps_ms(dev, rel, torch.from_numpy(
                value_sets["full"]).to(dev), resolve_schedule(N_MAIN))
            log(f"  GPU_ONLY_PART agg-phase steps (ms, CUDA events): {steps}")
            out["agg_steps_ms"] = steps
    return out


def check_probe_kernel(dev) -> dict[str, int]:
    """Phases 2-3, continued: kernel F against ``probe_plain``, bit for
    bit, over ``GRID_PROBE``."""
    limit = pprobe.max_shared_keys()
    err = 0
    for p, k, m in GRID_PROBE:
        for order in ("sorted", "permuted"):
            tk, tr, pk = random_layout(p, k, m, seed=p + k, device=dev,
                                       sorted_rows=order == "sorted")
            got = pprobe.probe(tk, tr, pk)
            e = max_abs_diff(got, pprobe.probe_plain(tk, tr, pk))
            torch.cuda.synchronize()
            log(f"  P={p} K={k} M={m} {order} rows "
                f"({'shared' if k <= limit else 'device'} memory, "
                f"{int((got >= 0).sum())} hits): F err={e}")
            assert e == 0, ("partitioned_probe", p, k, m, order, e)
            err = max(err, e)
    assert GRID_PROBE[-1][1] > limit, ("no row past shared memory", limit)
    # build_partitioned_table's own rows, with negative build keys:
    # [non-negative ascending][negative ascending][INT_MAX pads].
    n = 1 << 16
    rng = np.random.default_rng(7)
    build = Relation(torch.arange(n, dtype=torch.int32, device=dev),
                     torch.from_numpy(rng.integers(-n, n, n)
                                      .astype(np.int32)).to(dev))
    probe = Relation(torch.arange(n, dtype=torch.int32, device=dev),
                     torch.from_numpy(rng.integers(-n // 2, 3 * n // 2, n)
                                      .astype(np.int32)).to(dev))
    tk, tr, qk, _ = pops.build_partitioned_table(build, probe, total_bits=7)
    e = max_abs_diff(pprobe.probe(tk, tr, qk), pprobe.probe_plain(tk, tr, qk))
    torch.cuda.synchronize()
    log(f"  build_partitioned_table, negative build keys, P=128 "
        f"K={tk.shape[1]} M={qk.shape[1]}: F err={e}")
    assert e == 0, ("partitioned_probe negative layout", e)
    return {"partitioned_probe": err}


def check_clustered_hist(dev) -> dict[str, int]:
    """Phases 2-3, continued: kernel E on clustered pids (``_headers``'s
    input) against ``radix_hist_plain``, bit for bit: runs that cross
    vector, warp and block edges with out-of-range pids inside them, over
    ragged n x P, aligned and 4 bytes past a 16-byte boundary."""
    err = 0
    for n in E_CLUSTER_NS:
        for p in E_CLUSTER_PARTS:
            base = clustered_pids(n + 1, p, seed=n + p, device=dev)
            for name, pid in (("aligned", base[:n]), ("offset", base[1:])):
                e = max_abs_diff(partition_hist.radix_hist(pid, num_parts=p),
                                 partition_hist.radix_hist_plain(
                                     pid, num_parts=p))
                torch.cuda.synchronize()
                assert e == 0, ("radix_hist clustered", n, p, name, e)
                err = max(err, e)
        log(f"  n={n} clustered, P in {E_CLUSTER_PARTS}, aligned and "
            f"offset: E err={err}")
    return {"radix_hist": err}


def check_wide_probe(dev, n: int = 1 << 16) -> dict[str, int]:
    """Phase 7, continued: the layout packing and kernel F at 2^17
    partitions (past the old 2^16 cap), unique(n) x uniform(n), the probe
    against its plain version bit for bit and the pairs against the join
    oracle."""
    build = unique_relation(n, seed=3, device=dev)
    probe = uniform_relation(n, seed=4, device=dev)
    rk.reset_launch_counts()
    layout = pops.build_partitioned_table(build, probe,
                                          total_bits=WIDE_PROBE_BITS)
    rid = pops.probe(*layout[:3])
    counts = rk.launch_counts()
    assert counts["partitioned_probe"] == 1 and counts["radix_hist"] == 2, \
        counts
    e = max_abs_diff(rid, pprobe.probe_plain(*layout[:3]))
    got = probe_pairs(layout[3], rid)
    exp = join_oracle(build, probe)
    assert e == 0 and got.shape == exp.shape and np.array_equal(got, exp), \
        ("wide partitioned probe", e)
    log(f"  P=2^{WIDE_PROBE_BITS} K={layout[0].shape[1]} "
        f"M={layout[2].shape[1]}, {n} x {n}: F err={e}, {len(exp)} "
        "matches, verified against the oracle")
    return {"partitioned_probe": e}


def probe_pairs(qr: torch.Tensor, rid: torch.Tensor) -> np.ndarray:
    """Sorted (probe rid, match rid) pairs of the matched probe slots."""
    hit = rid >= 0
    pairs = torch.stack([qr[hit], rid[hit]], 1).cpu().numpy()
    pairs = pairs.astype(np.int64)
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]


def run_probe_join(dev, n: int = N_MAIN) -> dict:
    """Phase 7: the partitioned probe join, unique(n, seed 1) x
    uniform(n, seed 2) at 13 bits: ``build_partitioned_table`` and
    ``probe`` each timed with CUDA events after one warm-up, the pairs
    verified against the join oracle."""
    build = unique_relation(n, seed=1, device=dev)
    probe = uniform_relation(n, seed=2, device=dev)
    exp = join_oracle(build, probe)
    pops.probe(*pops.build_partitioned_table(
        build, probe, total_bits=PROBE_BITS)[:3])          # warm-up
    torch.cuda.synchronize()
    rk.reset_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    layout = pops.build_partitioned_table(build, probe,
                                          total_bits=PROBE_BITS)
    ev[1].record()
    rid = pops.probe(*layout[:3])
    ev[2].record()
    ev[2].synchronize()
    counts = rk.launch_counts()
    out = {"n": n, "total_bits": PROBE_BITS,
           "caps": [layout[0].shape[1], layout[2].shape[1]],
           "build_ms": ev[0].elapsed_time(ev[1]),
           "probe_ms": ev[1].elapsed_time(ev[2]), "launches": counts}
    log(f"  layout P={1 << PROBE_BITS} K={out['caps'][0]} "
        f"M={out['caps'][1]}: build_partitioned_table "
        f"{out['build_ms']:.3f} ms, probe {out['probe_ms']:.3f} ms "
        f"(CUDA events), launches {counts}")
    for name in ("hash_bucket", "radix_hist", "partitioned_probe"):
        assert counts[name] > 0, f"partitioned probe join never launched {name}"
    got = probe_pairs(layout[3], rid)
    assert got.shape == exp.shape and np.array_equal(got, exp), \
        "partitioned probe join"
    log(f"  partitioned probe join {n} x {n}: {len(exp)} matches, "
        "verified against the oracle")
    return out


def run_shj(dev, n_main: int = N_MAIN, n_dd: int = N_DD) -> dict:
    """Phase 8: the co-processed SHJ (C = host CPU, G = the card), every
    run verified against the join oracle or the variant oracle."""
    cp = CoProcessor(c_device="cpu", g_device=dev)
    cp_pcie = CoProcessor(c_device="cpu", g_device=dev, link=PCIE_LINK,
                          discrete=True)
    out = {}

    def check(what, res, t, exp, counts, needs_card):
        log(f"  {what}: phases {phase_ms(t)} ms, merge "
            f"{t.merge_s * 1e3:.3f} ms, transfer {t.transfer_bytes} B "
            f"({t.transfer_s * 1e3:.3f} ms emulated), launches {counts}")
        if needs_card:
            assert counts["hash_bucket"] > 0, f"{what} never launched D"
        else:   # the whole series ran on the host
            assert not any(counts.values()), (what, counts)
        verify(res, exp, what)
        out[what] = {"phase_ms": phase_ms(t), "merge_ms": t.merge_s * 1e3,
                     "transfer_bytes": t.transfer_bytes, "launches": counts}

    for n in (n_main, n_dd):
        build = uniform_relation(n, seed=1, device=dev)
        probe = uniform_relation(n, seed=2, device=dev)
        exp = uniform_oracle(n)
        # num_buckets n/4 and max_out 2n + matches, as
        # examples/coprocess_join.py sizes them.
        kw = dict(num_buckets=n // 4, max_out=2 * n + len(exp))
        if n == n_main:
            runs = [("GPU_ONLY", cp, [0.0] * 4, [0.0] * 4, "shared")]
            cp.shj(build, probe, build_ratios=[0.0] * 4,
                   probe_ratios=[0.0] * 4, **kw)                # warm-up
        else:
            runs = [(name, cp, br, pr, mode)
                    for name, br, pr in (
                        ("CPU_ONLY", [1.0] * 4, [1.0] * 4),
                        ("DD", [0.25] * 4, [0.42] * 4),
                        ("PL", [0.0, 0.25, 0.5, 0.25],
                         [0.0, 0.25, 0.75, 0.25]))
                    for mode in ("shared", "separate")]
            runs.append(("DD_PCIE", cp_pcie, [0.25] * 4, [0.42] * 4,
                         "separate"))
        for name, c, br, pr, mode in runs:
            torch.cuda.synchronize()
            rk.reset_launch_counts()
            res, t = c.shj(build, probe, build_ratios=br, probe_ratios=pr,
                           table_mode=mode, **kw)
            counts = rk.launch_counts()
            check(f"shj {name} {mode} n={n}", res, t, exp, counts,
                  name != "CPU_ONLY")
        if n == n_dd:
            torch.cuda.synchronize()
            rk.reset_launch_counts()
            res, t, ratios = cp.basic_unit_shj(build, probe, chunk=n // 16,
                                               **kw)
            counts = rk.launch_counts()
            assert all(0.0 <= r <= 1.0 for r in ratios.values()), ratios
            log(f"  basic_unit_shj chunk={n // 16}: C ratios {ratios}")
            check(f"basic_unit_shj n={n}", res, t, exp, counts, True)
        # Variants against one table from build_table.
        ratios = [0.0] * 4 if n == n_main else [0.25] * 4
        table, _ = cp.build_table(build, num_buckets=kw["num_buckets"],
                                  ratios=ratios)
        for kind in ("semi", "anti", "left_outer"):
            vexp = jv.join_variant_oracle(build, probe, kind)
            pr = [0.0] * 4 if n == n_main else [0.42] * 4
            torch.cuda.synchronize()
            rk.reset_launch_counts()
            res, t = jv.probe_table_variant(cp, probe, table, kind=kind,
                                            max_out=kw["max_out"],
                                            ratios=pr)
            counts = rk.launch_counts()
            check(f"probe_table_variant {kind} "
                  f"{'GPU_ONLY' if n == n_main else 'DD'} n={n}", res, t,
                  vexp, counts, True)
    return out


def time_probe_kernel(dev) -> dict:
    """Phase 6, continued: F at path F's shape (2^24 x 2^24 at 13 bits),
    beside its bytes bound, ``probe_plain`` and the library composite
    (batched ``torch.searchsorted`` + gathers, ``probe_ref``)."""
    build = unique_relation(N_MAIN, seed=1, device=dev)
    probe = uniform_relation(N_MAIN, seed=2, device=dev)
    tk, tr, qk, _ = pops.build_partitioned_table(build, probe,
                                                 total_bits=PROBE_BITS)
    p, k = tk.shape
    m = qk.shape[1]
    hits = int((pprobe.probe(tk, tr, qk) >= 0).sum())
    row = {
        "shape": f"P={p}, K={k}, M={m}, {hits} hits",
        "ms": cuda_ms(lambda: pprobe.probe(tk, tr, qk)),
        "graph_ms": graph_ms(lambda: pprobe.probe(tk, tr, qk)),
        "plain_ms": cuda_ms(lambda: pprobe.probe_plain(tk, tr, qk)),
        "library_ms": cuda_ms(lambda: probe_ref(tk, tr, qk)),
        "library": "composite: batched torch.searchsorted (uint32 order in "
                   "int64) + 2 torch.gather (probe_ref)",
        # Keys and probe keys read once, the match rids written, one rid
        # read per hit.
        "bound_ms": (p * k + 2 * p * m + hits) * 4 / HBM_BYTES_PER_S * 1e3}
    log(f"  partitioned_probe: {row}")
    return {"partitioned_probe": row}


def library_seg_agg(gid: torch.Tensor, val: torch.Tensor, slots: int):
    """The composite yardstick for C: bincount + index_add_ (int64) +
    scatter_reduce_ amin + amax, the PyTorch calls that together compute
    count, sum, min and max per slot."""
    g64 = gid.to(torch.int64)
    v64 = val.to(torch.int64)
    return lambda: (
        torch.bincount(g64, minlength=slots),
        torch.zeros(slots, dtype=torch.int64, device=gid.device)
        .index_add_(0, g64, v64),
        torch.full((slots,), agg.INT32_MAX, dtype=torch.int32,
                   device=gid.device).scatter_reduce_(
                       0, g64, val, "amin", include_self=True),
        torch.full((slots,), agg.INT32_MIN, dtype=torch.int32,
                   device=gid.device).scatter_reduce_(
                       0, g64, val, "amax", include_self=True))


def time_group_kernels(dev) -> dict[str, dict]:
    """Phase 6, continued: C at n = S = 2^24 with sorted gids from 2^18
    groups (the GPU_ONLY unpartitioned group-by's reduce), D at 2^24 with
    B = 2^13 and E at 2^24 with P = 2^13 on uniform and on clustered pids
    (the headers of a (7, 6) schedule)."""
    n = N_MAIN
    keys, value_sets = group_data(n, seed=n)
    skeys = torch.sort(torch.from_numpy(keys).to(dev)).values
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = skeys[1:] != skeys[:-1]
    gid = (torch.cumsum(first, 0, dtype=torch.int32) - 1).to(torch.int32)
    val = torch.from_numpy(value_sets["full"]).to(dev)
    rows = agg.sum_rows(n, False)
    out = {"seg_agg": {
        "shape": f"n=S={n}, {n // 64} groups, sorted gid, {rows} sum rows",
        "ms": cuda_ms(lambda: agg.seg_agg(gid, val, num_slots=n)),
        "plain_ms": cuda_ms(lambda: agg.seg_agg_plain(gid, val,
                                                      num_slots=n)),
        "library_ms": cuda_ms(library_seg_agg(gid, val, n)),
        "library": "bincount + index_add_ int64 + scatter_reduce_ amin + "
                   "amax (summed)",
        "bound_ms": (8 * n + 4 * (3 + rows) * n) / HBM_BYTES_PER_S * 1e3}}
    rel = uniform_relation(n, seed=1, device=dev)
    rel_keys = rel.key
    b = 1 << 13
    out["hash_bucket"] = {
        "shape": f"n={n}, B={b}",
        "ms": cuda_ms(lambda: hsh.hash_bucket(rel_keys, num_buckets=b)),
        "plain_ms": cuda_ms(lambda: hsh.hash_bucket_plain(rel_keys,
                                                          num_buckets=b)),
        "library_ms": None, "library": "none: no PyTorch call hashes",
        "bound_ms": 8 * n / HBM_BYTES_PER_S * 1e3}
    # E on its two inputs: the uniform pids hash_bucket gives the packing
    # of the partitioned probe join, and the clustered pids of the final
    # headers (_headers) of a relation partitioned by the (7, 6) schedule,
    # which phj_join and the partitioned group-by give it.
    parts = radix_partition_scheduled(rel, schedule=(7, 6)).rel
    rows = []
    for name, pid in (("uniform (hash_bucket)",
                       hsh.hash_bucket(rel_keys, num_buckets=b)),
                      ("clustered (_headers after (7, 6))",
                       radix_of(parts.key, shift=0, bits=13))):
        e = max_abs_diff(partition_hist.radix_hist(pid, num_parts=b),
                         partition_hist.radix_hist_plain(pid, num_parts=b))
        assert e == 0, ("radix_hist", name, e)
        run = (lambda: partition_hist.radix_hist(pid, num_parts=b))
        rows.append({
            "shape": f"n={n}, P={b}, {name} pids",
            "ms": cuda_ms(run), "graph_ms": graph_ms(run),
            "plain_ms": cuda_ms(lambda: partition_hist.radix_hist_plain(
                pid, num_parts=b)),
            "library_ms": cuda_ms(lambda: torch.bincount(pid, minlength=b)),
            "library": "torch.bincount",
            "bound_ms": (4 * n + 4 * b) / HBM_BYTES_PER_S * 1e3})
    # The row itself times the uniform input; both stand under per_input.
    out["radix_hist"] = dict(rows[0], per_input=rows)
    for name, row in out.items():
        log(f"  {name}: {row}")
    return out


def time_kernels(dev, sched) -> dict[str, list]:
    """Phase 6: each kernel at the main path's passes (n = 2^24)."""
    rel = uniform_relation(N_MAIN, seed=1, device=dev)
    out = {name: [] for name in ("partition_hist_fused", "radix_scatter")}
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
            "path": ("shared memory" if reorder.uses_shared(1 << bits)
                     else "device memory"),
            "ms": cuda_ms(lambda: reorder.radix_scatter(
                rel.rid, keys, pid, starts, num_parts=1 << bits)),
            "plain_ms": cuda_ms(lambda: reorder.radix_scatter_plain(
                rel.rid, keys, pid)),
            "library_ms": cuda_ms(lambda: (lambda o: (rel.rid[o], keys[o]))(
                torch.sort(pid, stable=True).indices))}
        row_b["vs_library"] = ("no slower" if row_b["ms"] <= row_b[
            "library_ms"] else "slower")
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


def close_err(got: torch.Tensor, want: torch.Tensor, tol: float,
              what) -> float:
    """Largest |got - want|; raises unless every element is within
    ``tol + tol |want|`` (tests/test_kernels.py's assert_allclose)."""
    got, want = got.float(), want.float()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert bool(torch.isfinite(got).all()), (what, "non-finite output")
    diff = (got - want).abs()
    assert bool((diff <= tol + tol * want.abs()).all()), \
        (what, float(diff.max()))
    return float(diff.max())


def g_inputs(shape, dtype, dev, seed: int):
    b, sq, sk, h, kv, d, _ = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype),
            torch.randn(b, sk, kv, d, generator=g, device=dev).to(dtype),
            torch.randn(b, sk, kv, d, generator=g, device=dev).to(dtype))


def h_inputs(shape, dtype, dev, seed: int):
    bs, nc, q, h, p, n = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(bs, nc, q, h, p, generator=g, device=dev).to(dtype),
            torch.rand(bs, nc, q, h, generator=g, device=dev) * 0.19 + 0.01,
            torch.randn(bs, nc, q, n, generator=g, device=dev).to(dtype),
            torch.randn(bs, nc, q, n, generator=g, device=dev).to(dtype),
            -torch.exp(torch.randn(h, generator=g, device=dev) * 0.3))


def check_lm_kernels(dev) -> dict[str, float]:
    """Phase 9: kernels G and H against their plain versions over their
    grids, in float32 (TF32 off) and in bfloat16; H in both variants:
    bfloat16 through the tensor-core (wgmma) variant that serves it, and
    through the CUDA-core variant too, which serves float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    err = {"flash_attn": 0.0, "ssd_intra_chunk": 0.0}
    for dtype, tol in TOL_G.items():
        for i, shape in enumerate(GRID_G):
            q, k, v = g_inputs(shape, dtype, dev, seed=i)
            kv, causal = shape[4], shape[6]
            got = fa.flash_attention(q, k, v, num_kv_heads=kv, causal=causal)
            want = fa.flash_attention_plain(q, k, v, num_kv_heads=kv,
                                            causal=causal)
            e = close_err(got, want, tol, ("flash_attn", shape, dtype))
            err["flash_attn"] = max(err["flash_attn"], e)
            log(f"  G {shape} {dtype}: max abs err {e:.3g} (tol {tol})")
            del q, k, v, got, want
    by_variant = {}
    for dtype, variant in ((torch.bfloat16, None),
                           (torch.bfloat16, "cuda_cores"),
                           (torch.float32, None)):
        tol = TOL_H[dtype]
        for i, shape in enumerate(GRID_H):
            args = h_inputs(shape, dtype, dev, seed=i)
            before = dict(kssd.launches_by_variant)
            got = kssd.ssd_intra_chunk(*args, variant=variant)
            ran = next(n for n, c in kssd.launches_by_variant.items()
                       if c != before[n])
            assert ran == (variant or kssd.variant_for(dtype)), (shape, ran)
            want = kssd.ssd_intra_chunk_plain(*args)
            e = close_err(got, want, tol, ("ssd_intra_chunk", shape, dtype))
            err["ssd_intra_chunk"] = max(err["ssd_intra_chunk"], e)
            key = f"{ran} {str(dtype).replace('torch.', '')}"
            by_variant[key] = max(by_variant.get(key, 0.0), e)
            log(f"  H {shape} {dtype} {ran}: max abs err {e:.3g} "
                f"(tol {tol} + {tol} |want|)")
    for key, e in by_variant.items():
        log(f"  H {key}: largest error over GRID_H {e:.3g}")
    assert kssd.variant_for(torch.bfloat16) == "wgmma"
    torch.cuda.synchronize()
    return err


class Capture:
    """Records the inputs of the first call of a layer's kernel wrapper
    while the prefill runs, and passes every call on unchanged."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.args = None

    def __enter__(self):
        def wrapper(*args, **kw):
            if self.args is None:
                self.args = ([a.clone() for a in args], dict(kw))
            return self.fn(*args, **kw)
        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def run_lm_serving(dev, cfg, batches=LM_BATCHES) -> dict:
    """Phase 10: ``cfg`` (Zamba2-1.2B at full width and depth in the run
    of ``main``; random weights from seed 0) served through
    ``ServeEngine.generate`` for each (batch, prompt, new) of ``batches``;
    launch
    counts per generate (G and H only in the prefill), decode logits
    against ``forward_train`` (G and H) on the generated sequences, G and
    H against their plain versions on the prefill's own activations, and
    CUDA-event times."""
    layers = cfg.pattern_unit * cfg.num_units + cfg.tail
    n_attn, n_mamba = layers.count("A") + layers.count("D"), layers.count("M")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"  {cfg.name}: {cfg.num_layers} layers ({layers}), {n_params} "
        f"parameters, initialised in {time.perf_counter() - t0:.1f} s")
    out = {"arch": cfg.name, "params": n_params, "batches": {}}
    for bi, (batch, plen, new) in enumerate(batches):
        rng = np.random.default_rng(bi)
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (batch, plen), dtype=np.int32)).to(dev)
        engine = ServeEngine(cfg, params, max_seq=plen + new)
        what = f"{batch} x {plen} + {new}"
        if bi == 0:   # warm-up, with the activations of one G and one H
            with Capture(lattn, "flash_attention") as cg, \
                    Capture(lssd, "ssd_intra_chunk") as ch:
                engine.generate(prompts, new)
        else:
            engine.generate(prompts, new)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        rk.reset_launch_counts()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        tokens, logits = engine.generate(prompts, new, return_logits=True)
        ev[1].record()
        ev[1].synchronize()
        counts = rk.launch_counts()
        variants = dict(fa.launches_by_variant)
        h_variants = dict(kssd.launches_by_variant)
        gen_ms = ev[0].elapsed_time(ev[1])
        peak = torch.cuda.max_memory_allocated(dev)
        log(f"  generate {what}: {gen_ms:.3f} ms, launches {counts}, G by "
            f"variant {variants}, H by variant {h_variants}, peak {peak} B")
        assert counts["flash_attn"] == n_attn, counts
        assert variants["wgmma"] == n_attn, variants   # head_dim 64, bf16
        assert counts["ssd_intra_chunk"] == n_mamba, counts
        assert h_variants["wgmma"] == n_mamba, h_variants   # bf16
        assert sum(counts.values()) == n_attn + n_mamba, counts
        assert tokens.shape == (batch, plen + new)
        assert torch.equal(tokens[:, :plen].cpu(), prompts.cpu())
        assert bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())
        assert bool(torch.isfinite(logits.float()).all())

        # Decode (plain attention, recurrent SSD) against forward_train
        # (G and H) at every generated position.
        rk.reset_launch_counts()
        full, _ = tfm.forward_train(params, cfg, tokens[:, :-1])
        fwd_counts = rk.launch_counts()
        assert fwd_counts["flash_attn"] == n_attn, fwd_counts
        assert fwd_counts["ssd_intra_chunk"] == n_mamba, fwd_counts
        ref = full[:, plen - 1:].float()[..., :cfg.vocab_size]
        got = logits.float()[..., :cfg.vocab_size]
        rel = float((got - ref).abs().max() / ref.abs().max())
        agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
        log(f"  decode vs forward_train logits: max|d|/max|logits| "
            f"{rel:.4g} (limit {LM_REL_LIMIT}); argmax agreement {agree}")
        assert rel < LM_REL_LIMIT, (what, rel)
        del full, ref, got

        # The two steps on their own, each timed with CUDA events.
        prefill = make_prefill_step(cfg)
        step = make_decode_step(cfg)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        plog, cache = prefill(params, {"tokens": prompts})
        ev[1].record()
        cache = grow_cache(cfg, cache, batch, plen + new, dev)
        tok = torch.argmax(plog, -1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        rk.reset_launch_counts()
        ev[2].record()
        for n in range(plen, plen + new - 1):
            tok, _, cache = step(params, cache, tok, n)
        ev[3].record()
        ev[3].synchronize()
        assert not any(rk.launch_counts().values()), rk.launch_counts()
        prefill_ms = ev[0].elapsed_time(ev[1])
        decode_ms = ev[2].elapsed_time(ev[3]) / (new - 1)
        row = {"batch": batch, "prompt": plen, "new": new,
               "generate_ms": gen_ms, "prefill_ms": prefill_ms,
               "decode_ms_per_step": decode_ms,
               "tokens_per_s": batch * new / (gen_ms / 1e3),
               "decode_tokens_per_s": batch / (decode_ms / 1e3),
               "peak_bytes": peak, "rel_logits": rel,
               "argmax_agreement": agree, "launches": counts,
               "flash_attn_variants": variants,
               "ssd_intra_chunk_variants": h_variants}
        log(f"  {what}: prefill {prefill_ms:.3f} ms, decode "
            f"{decode_ms:.3f} ms per step, {row['tokens_per_s']:.1f} tok/s "
            "over generate")
        out["batches"][what] = row
        del cache, tokens, logits

    # G and H on the prefill's own activations (first attention block,
    # first Mamba2 block of the 4 x 2048 warm-up prefill).
    (q, k, v), kw = cg.args
    got = fa.flash_attention(q, k, v, **kw)
    want = fa.flash_attention_plain(q, k, v, **kw)
    eg = close_err(got, want, TOL_G[q.dtype], "G on Zamba2 activations")
    args, _ = ch.args
    before = kssd.launches_by_variant["wgmma"]
    got = kssd.ssd_intra_chunk(*args)
    assert kssd.launches_by_variant["wgmma"] == before + 1
    want = kssd.ssd_intra_chunk_plain(*args)
    eh = close_err(got, want, TOL_H[args[0].dtype],
                   "H on Zamba2 activations")
    log(f"  real activations: G q {tuple(q.shape)} err {eg:.3g}; H x "
        f"{tuple(args[0].shape)} err {eh:.3g}")
    out["activation_err"] = {"flash_attn": eg, "ssd_intra_chunk": eh}
    return out


def library_ssd(x, dt, b, c, a):
    """The composite yardstick for H: two batched torch.matmul (C B^T and
    W X) around the decay mask, in float32; Y comes out (B, NC, H, Q, P)."""
    dth = dt.permute(0, 1, 3, 2)                          # (B,NC,H,Q)
    cs = torch.cumsum(dth * a[:, None], dim=-1)
    q = x.shape[2]
    tril = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    decay = torch.exp(cs[..., :, None] - cs[..., None, :]).masked_fill(
        ~tril, 0.0)
    g = torch.matmul(c.float(), b.float().transpose(-1, -2))
    w = g[:, :, None] * decay * dth[..., None, :]
    return torch.matmul(w, x.float().permute(0, 1, 3, 2, 4))


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """Least milliseconds for the work, and what bounds it."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def time_g(dev, b: int, s: int, h: int, kv: int, d: int) -> dict:
    """G at q (b, s, h, d), k/v (b, s, kv, d) bf16 causal beside its
    operations bound, its plain version and SDPA on the same views."""
    q, k, v = g_inputs((b, s, s, h, kv, d, True), torch.bfloat16, dev, 99)
    pairs = s * (s + 1) // 2                 # causal (i, j), j <= i
    bms, bby = bound(4.0 * b * h * pairs * d,
                     2 * 2 * b * s * (h + kv) * d, BF16_FLOPS)
    before = dict(fa.launches_by_variant)
    fa.flash_attention(q, k, v, num_kv_heads=kv)
    variant = next(n for n, c in fa.launches_by_variant.items()
                   if c != before[n])
    row = {
        "shape": f"q ({b}, {s}, {h}, {d}), k/v ({b}, {s}, {kv}, {d}) bf16, "
                 "causal", "variant": variant,
        "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, num_kv_heads=kv)),
        "plain_ms": cuda_ms(lambda: fa.flash_attention_plain(
            q, k, v, num_kv_heads=kv), reps=3, warmup=1),
        "library_ms": cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=kv != h)),
        "library": "torch.nn.functional.scaled_dot_product_attention "
                   "(is_causal=True) on (B, H, S, D) views",
        "bound_ms": bms, "bound_by": bby}
    row["vs_library"] = ("no slower" if row["ms"] <= row["library_ms"]
                         else "slower")
    return row


def time_lm_kernels(dev) -> dict[str, dict]:
    """Phase 6, continued: G at Zamba2's prefill shape (4 x 2048 x 32
    heads of 64) and at the Qwen3-8B-shaped GQA shape of ``GRID_G``
    (2048, 32 / 8 heads of 128), H at Zamba2's prefill shape, all bf16,
    beside their bounds, plain versions and library calls."""
    zamba = time_g(dev, 4, 2048, 32, 32, 64)
    gqa = time_g(dev, 1, 2048, 32, 8, 128)
    out = {"flash_attn": dict(zamba, per_shape=[zamba, gqa])}
    bs, nc, cq, hh, p, n = 4, 8, 256, 64, 64, 64
    args = h_inputs((bs, nc, cq, hh, p, n), torch.bfloat16, dev, 98)
    tri = cq * (cq + 1) // 2
    rows = bs * nc * cq
    bms, bby = bound(2.0 * bs * nc * tri * (n + hh * p),
                     rows * (hh * p * 2 + hh * 4 + 2 * n * 2 + hh * p * 4)
                     + hh * 4, BF16_FLOPS)
    out["ssd_intra_chunk"] = {
        "shape": f"x ({bs}, {nc}, {cq}, {hh}, {p}) bf16, N {n}",
        "variant": kssd.variant_for(torch.bfloat16),
        "ms": cuda_ms(lambda: kssd.ssd_intra_chunk(*args)),
        "cuda_cores_ms": cuda_ms(lambda: kssd.ssd_intra_chunk(
            *args, variant="cuda_cores")),
        "plain_ms": cuda_ms(lambda: kssd.ssd_intra_chunk_plain(*args),
                            reps=5, warmup=1),
        "library_ms": cuda_ms(lambda: library_ssd(*args)),
        "library": "composite: torch.matmul C B^T + decay mask + "
                   "torch.matmul W X, float32",
        "bound_ms": bms, "bound_by": bby}
    for name, row in out.items():
        log(f"  {name}: {row}")
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

    log_phase("[2-3] kernels A-F against their plain versions (bit-exact)")
    err = check_kernels(dev)
    err.update(check_group_kernels(dev))
    err.update(check_probe_kernel(dev))
    for extra in (check_wide_kernels(dev), check_clustered_hist(dev)):
        for name, e in extra.items():
            err[name] = max(err[name], e)
    run_wide_joins(dev)

    log_phase("[4] main path: phj_join 2^24 x 2^24")
    main_path = run_main_path(dev)

    log_phase("[5] CoProcessor.phj")
    run_coprocessor(dev)

    log_phase("[5b] main path: CoProcessor.groupby")
    groupby = run_groupby(dev)

    log_phase("[7] main path: partitioned probe join 2^24 x 2^24")
    probe_join = run_probe_join(dev)
    err["partitioned_probe"] = max(err["partitioned_probe"],
                                   check_wide_probe(dev)["partitioned_probe"])

    log_phase("[8] main path: co-processed SHJ and join variants")
    shj = run_shj(dev)

    log_phase("[9] kernels G and H against their plain versions")
    err.update(check_lm_kernels(dev))

    log_phase(f"[10] main path: LM serving, {LM_ARCH} at full width")
    cfg = get_config(LM_ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.d_ff,
            cfg.dtype) == (38, 2048, 32, 8192, "bfloat16"), cfg
    lm = run_lm_serving(dev, cfg)

    log_phase("[6] kernel times at the main paths' shapes")
    times = time_kernels(dev, main_path["schedule"])
    other_times = time_group_kernels(dev)
    other_times.update(time_probe_kernel(dev))
    other_times.update(time_lm_kernels(dev))

    # Launches: A and B from phj_join (slice 1's path), C, D and E from
    # the GPU_ONLY partitioned group-by at 2^24, the path that added them,
    # F from the partitioned probe join.
    by_path = {"phj_join": main_path["launches"],
               "groupby_gpu_only_partitioned":
                   groupby["GPU_ONLY_PART/full"]["launches"],
               "partitioned_probe_join": probe_join["launches"],
               "shj_gpu_only":
                   shj[f"shj GPU_ONLY shared n={N_MAIN}"]["launches"],
               "lm_generate": next(iter(lm["batches"].values()))[
                   "launches"]}
    path_of = {"seg_agg": "groupby_gpu_only_partitioned",
               "hash_bucket": "groupby_gpu_only_partitioned",
               "radix_hist": "groupby_gpu_only_partitioned",
               "partitioned_probe": "partitioned_probe_join",
               "flash_attn": "lm_generate", "ssd_intra_chunk": "lm_generate"}
    record = []
    for name, meta in KERNELS.items():
        if name in times:
            first = times[name][0]
            row = {k: first[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "library_ms")}
            row["per_pass"] = times[name]
            path = "phj_join"
        else:
            row = other_times[name]
            path = path_of[name]
        if name in ("flash_attn", "ssd_intra_chunk"):
            row["launches_by_variant"] = next(iter(lm["batches"].values()))[
                f"{name}_variants"]
        record.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": by_path[path][name], "launches_path": path,
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": err[name], "bit_exact": err[name] == 0,
            "bound_by": "bytes", **row})
    for b in lm["batches"].values():
        log(f"  LM {b['batch']} x {b['prompt']} + {b['new']}: prefill "
            f"{b['prefill_ms']:.3f} ms, decode {b['decode_ms_per_step']:.3f}"
            f" ms/step, {b['tokens_per_s']:.1f} tok/s, peak "
            f"{b['peak_bytes'] / 2**30:.2f} GiB")
    log(f"  whole script {time.perf_counter() - T_START:.1f} s")
    log(smi)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
