"""Build, check and time the redesigned kernels G (flash attention), B
(radix scatter), H (SSD intra-chunk), A (fused radix digit + histogram),
E (radix histogram) and F (partitioned probe) on one CUDA card.

    python3 tools/check_hopper_kernels.py [--ptxas] [--quick] [--probe]
                                          [--only G,B,H,A,E,F]

With ``--ptxas`` it first compiles each chosen kernel's source once more
with ``nvcc -Xptxas -v`` and prints each kernel's registers, shared
memory and spills.  Then it holds G against ``flash_attention_plain``
(2e-2 bf16, 3e-5 f32), H against ``ssd_intra_chunk_plain`` (3e-2 +
3e-2 |want| bf16, 2e-4 f32, both variants, printing the largest error as
a share of that limit), and A, B and E against their plain versions (bit
for bit, digits past 16 bits too) over small grids of shapes, and times
them at the main paths' shapes beside their library calls: G at
(4, 2048, 32, 64) and (1, 2048, 2048, 32, 8, 128) bf16 causal against
``scaled_dot_product_attention``, B at 2^24 tuples for 7 and 6 bits
against a stable ``torch.sort`` + 2 gathers, H at Zamba2's prefill shape
x (4, 8, 256, 64, 64), N 64, bf16 against two ``torch.matmul`` around
the decay mask, A at 2^24 keys for 7 and 6 bits against ``torch.bincount``
of the finished pids, E at 2^24 pids over 2^13 bins, uniform and clustered
(sorted, as a partitioned relation's final headers see them), against
``torch.bincount``, and F at path F's layout (2^24 unique x 2^24 uniform
at 13 bits) against ``probe_ref`` (batched ``searchsorted`` + 2
gathers); E and F are held bit for bit against their plain versions first
(E on clustered pids with out-of-range pids inside the runs, ragged and
unaligned; F on sorted, permuted, unaligned and packed layouts, rows
longer than a pipelined stage).  ``--probe`` also checks and times the builds the
designs were chosen against (``-D`` flags of their sources, built beside
the ones every path uses): H with W rounded to bf16 once, on the CUDA
cores, with three consumer warpgroups, with one exponential per entry
of W, and, for timing only (their Y is wrong), without exponentials, on
half the SMs, and with clock64() stamps of each part of a head; A with
a match aggregation for narrow digits and with other block sizes and
loads in flight; E with other block sizes, blocks per SM, loads in flight
and sub-histogram copies; F without the top table, without staged rids,
with 1 or 2 keys a thread, with no stage ahead of its six consumer groups
and with 7 groups of 4 warps (these builds are typed by ``_build.kernel``
and launched here through ``_build.launch``, so the wrappers every path
calls take no build flags); beside PyTorch's own passes over the same bytes
(``x.float()`` for H, ``keys.clone()`` for A, ``pid.amax()`` and
``pid.clone()`` for E, ``tk.clone()`` + ``qk.clone()`` for F).
``--quick`` stops after the checks.  Prints the card's name and power
limit first.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import functools
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import (Relation, unique_relation,  # noqa: E402
                              uniform_relation)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels._build import I32, I64, PTR  # noqa: E402
from repro_torch.kernels.flash_attn import flash_attn as fa  # noqa: E402
from repro_torch.kernels.partition_hist import fused  # noqa: E402
from repro_torch.kernels.partition_hist import partition_hist  # noqa: E402
from repro_torch.kernels.partition_hist import reorder  # noqa: E402
from repro_torch.kernels.partition_hist.ref import clustered_pids  # noqa: E402
from repro_torch.kernels.probe import ops as pops  # noqa: E402
from repro_torch.kernels.probe import probe as pprobe  # noqa: E402
from repro_torch.kernels.probe.ref import probe_ref, random_layout  # noqa: E402
from repro_torch.kernels.ssd import ssd as kssd  # noqa: E402
from repro_torch.obs import timing  # noqa: E402
from repro_torch.obs.timing import graph_ms  # noqa: E402

G_CHECK = ((1, 128, 128, 2, 2, 64, True), (1, 128, 128, 2, 2, 128, True),
           (2, 256, 256, 4, 2, 64, True), (1, 128, 384, 8, 8, 128, False),
           (1, 1000, 1000, 8, 2, 64, True), (1, 129, 300, 4, 1, 128, False),
           (1, 1, 1, 2, 1, 64, True), (4, 2048, 2048, 32, 32, 64, True),
           (1, 2048, 2048, 32, 8, 128, True))
B_CHECK = ((4095, 7), (4097, 6), (3 * 4096 + 17, 1), (1_000_003, 7),
           (1 << 22, 11), (1 << 20, 13), (1 << 20, 17), ((1 << 20) + 3, 18))
# (B, NC, Q, H, P, N): chip_smoke.py's GRID_H, one chunk of one row and
# a ragged chunk of 129 rows at N = 128.
H_CHECK = ((2, 3, 64, 4, 32, 16), (1, 2, 128, 8, 64, 64),
           (1, 2, 128, 4, 64, 128), (4, 8, 256, 64, 64, 64),
           (1, 4, 256, 80, 64, 128), (2, 1, 37, 64, 64, 64),
           (1, 1, 1, 2, 16, 64), (1, 3, 129, 6, 64, 128))
H_TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-4}   # test_kernels.py:128
A_BITS = (1, 2, 3, 7, 13, 14, 15, 17, 18)
A_SIZES = (0, 1, 5, 4099, (1 << 20) + 3)
H_SINGLE_W = ("-DSSD_SPLIT_W=0",)      # W rounded to bf16 once
# Builds the design was chosen against: three consumer warpgroups, the
# decay as one exponential per entry, and (timing only, a wrong Y) no
# exponentials at all and half the SMs.
H_PROBES = (("-DSSD_CONSUMERS=3",), ("-DSSD_FACTOR_EXP=0",),
            ("-DSSD_PROBE=2",), ("-DSSD_GRID_CAP=66",))
# A's other block sizes and int4 loads in flight per thread.
A_PROBES = (("-DA_THREADS=256",), ("-DA_THREADS=1024",), ("-DA_U=2",),
            ("-DA_U=8",))
A_MATCH = ("-DMATCH_MAX_BITS=3",)   # __match_any_sync up to 3 bits
H_STAMPS = ("-DSSD_PROBE=7",)       # clock64() stamps in Y (stamps_h)
# E: (n, P) checked on uniform and clustered pids, aligned and 4 bytes
# past alignment; the builds its design was chosen against.
E_SIZES = (0, 1, 3, 4099, (1 << 20) + 3)
E_PARTS = (1, 2, 1 << 13, 1 << 14, 1 << 15, 1 << 17)
E_PROBES = (("-DE_THREADS=512",),
            ("-DE_THREADS=512", "-DE_BLOCKS_PER_SM=1"), ("-DE_THREADS=256",),
            ("-DE_U=2",), ("-DE_U=8",), ("-DE_COPIES=1",), ("-DE_COPIES=4",))
# F: (P, K, M) checked on sorted and unsorted rows; the builds its design
# was chosen against.
F_CHECK = ((1, 1, 8), (3, 1, 37), (16, 4, 300), (16, 37, 300),
           (64, 36, 100), (64, 37, 129), (1, 2304, 5000), (16, 2304, 2304),
           (8192, 2304, 2432), (16, 32768, 4096))
F_PROBES = (("-DF_TOP=0",), ("-DF_STAGE_RIDS=0",), ("-DF_KPT=1",),
            ("-DF_KPT=2",), ("-DF_WS_STAGES=6",),
            ("-DF_WS_GROUPS=7", "-DF_WS_WARPS=4"))
HBM = 3.35e12
# chip_smoke.py's method, at 20 calls a run.
cuda_ms = functools.partial(timing.cuda_ms, reps=20, warmup=3)


def prebuild(pairs) -> None:
    """Compile every (source, defines) build at once, one nvcc each."""
    started = [(name, _build._start(name, d)) for name, d in pairs]
    for name, st in started:
        _build._finish(name, st)


def ptxas(name: str) -> None:
    out = _build.build_dir() / f"ptxas-{name}.cubin"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-cubin", "-Xptxas", "-v", "-o", str(out),
           str(_build.CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    print(f"ptxas {name}.cu (exit {res.returncode}):")
    for line in (res.stdout + res.stderr).splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling", "error",
                                    "smem", "Performance", "wgmma")):
            print("  " + line.strip())


def g_inputs(shape, dtype, seed):
    b, sq, sk, h, kv, d, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(*s, generator=g, device="cuda").to(dtype)
            for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]


def check_g() -> None:
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 3e-5)):
        for i, shape in enumerate(G_CHECK):
            q, k, v = g_inputs(shape, dtype, i)
            kv, causal = shape[4], shape[6]
            before = dict(fa.launches_by_variant)
            got = fa.flash_attention(q, k, v, num_kv_heads=kv,
                                     causal=causal).float()
            want = fa.flash_attention_plain(q, k, v, num_kv_heads=kv,
                                            causal=causal).float()
            torch.cuda.synchronize()
            ran = [n for n, c in fa.launches_by_variant.items()
                   if c != before[n]]
            diff = (got - want).abs()
            ok = bool(torch.isfinite(got).all()) and bool(
                (diff <= tol + tol * want.abs()).all())
            print(f"G {shape} {dtype} {ran}: max abs err "
                  f"{float(diff.max()):.4g} (tol {tol}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            assert ok, (shape, dtype)


def check_b() -> None:
    for n, bits in B_CHECK:
        rng = np.random.default_rng(n + bits)
        p = 1 << bits
        for order in ("uniform", "skew", "descending"):
            pid = rng.integers(0, p, n).astype(np.int32)
            if order == "skew":
                pid[:] = p - 1
            elif order == "descending":
                pid = -np.sort(-pid)
            pid_t = torch.from_numpy(pid).cuda()
            rid = torch.arange(n, dtype=torch.int32, device="cuda")
            key = torch.from_numpy(rng.integers(-2**31, 2**31, n)
                                   .astype(np.int32)).cuda()
            hist = torch.bincount(pid_t, minlength=p).to(torch.int32)
            starts = torch.cumsum(hist, 0, dtype=torch.int32) - hist
            got = reorder.radix_scatter(rid, key, pid_t, starts,
                                        num_parts=p)
            want = reorder.radix_scatter_plain(rid, key, pid_t)
            ok = all(torch.equal(a, b) for a, b in zip(got, want))
            print(f"B n={n} bits={bits} {order}: "
                  f"{'bit-exact' if ok else 'FAIL'}", flush=True)
            assert ok, (n, bits, order)


def time_g() -> None:
    for b, sq, sk, h, kv, d in ((4, 2048, 2048, 32, 32, 64),
                                (1, 2048, 2048, 32, 8, 128)):
        q, k, v = g_inputs((b, sq, sk, h, kv, d, True), torch.bfloat16, 7)
        flops = 4.0 * b * h * (sq * (sq + 1) // 2) * d
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, num_kv_heads=kv))
        lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=kv != h))
        print(f"G time ({b}, {sq}, {h}/{kv}, {d}) bf16 causal: {ms:.5f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), SDPA {lib:.5f} ms, bound "
              f"{flops / 989e12 * 1e3:.5f} ms", flush=True)


def time_b() -> None:
    n = 1 << 24
    rng = np.random.default_rng(5)
    rid = torch.arange(n, dtype=torch.int32, device="cuda")
    key = torch.from_numpy(rng.integers(-2**31, 2**31, n)
                           .astype(np.int32)).cuda()
    for bits in (7, 6):
        p = 1 << bits
        pid = torch.from_numpy(rng.integers(0, p, n).astype(np.int32)).cuda()
        hist = torch.bincount(pid, minlength=p).to(torch.int32)
        starts = torch.cumsum(hist, 0, dtype=torch.int32) - hist
        ms = cuda_ms(lambda: reorder.radix_scatter(rid, key, pid, starts,
                                                   num_parts=p))

        def lib():
            o = torch.sort(pid, stable=True).indices
            return rid[o], key[o]
        lib_ms = cuda_ms(lib)
        print(f"B time n=2^24 bits={bits}: {ms:.5f} ms, stable sort + 2 "
              f"gathers {lib_ms:.5f} ms, bound "
              f"{20 * n / 3.35e12 * 1e3:.5f} ms", flush=True)


def h_inputs(shape, dtype, seed):
    """chip_smoke.py's inputs for H: dt in [0.01, 0.2], a = -exp(0.3 z)."""
    bs, nc, q, h, p, n = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(bs, nc, q, h, p, generator=g, device="cuda").to(dtype),
            torch.rand(bs, nc, q, h, generator=g, device="cuda") * 0.19 + 0.01,
            torch.randn(bs, nc, q, n, generator=g, device="cuda").to(dtype),
            torch.randn(bs, nc, q, n, generator=g, device="cuda").to(dtype),
            -torch.exp(torch.randn(h, generator=g, device="cuda") * 0.3))


def h_share(got, want, tol: float) -> tuple[float, float]:
    """Largest |got - want| and its largest share of the limit
    tol + tol |want| (1.0 = at the limit)."""
    diff = (got - want).abs()
    return float(diff.max()), float((diff / (tol + tol * want.abs())).max())


def check_h(probe: bool) -> None:
    runs = [(torch.bfloat16, "wgmma", ()), (torch.float32, "cuda_cores", ()),
            (torch.bfloat16, "cuda_cores", ())]
    if probe:
        runs.append((torch.bfloat16, "wgmma", H_SINGLE_W))
    for dtype, variant, defines in runs:
        worst = 0.0
        for i, shape in enumerate(H_CHECK):
            args = h_inputs(shape, dtype, i)
            got = h_build(defines)(*args, variant=variant)
            want = kssd.ssd_intra_chunk_plain(*args)
            torch.cuda.synchronize()
            err, share = h_share(got, want, H_TOL[dtype])
            ok = bool(torch.isfinite(got).all()) and share <= 1.0
            worst = max(worst, share)
            print(f"H {shape} {dtype} {variant} {' '.join(defines)}: max abs "
                  f"err {err:.4g}, {share:.4f} of the limit "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            # A probing build is measured, not held to the limit.
            assert ok or defines, (shape, dtype, variant, defines)
        print(f"H {dtype} {variant} {' '.join(defines)}: largest share of "
              f"the limit {worst:.4f}", flush=True)


def check_a(probe: bool) -> None:
    rng = np.random.default_rng(11)
    for defines in ((), A_MATCH) if probe else ((),):
        digit = a_build(defines)
        for n in A_SIZES:
            keys = torch.from_numpy(rng.integers(-2**31, 2**31, n + 1)
                                    .astype(np.int32)).cuda()
            for bits in A_BITS:
                shift = 0 if bits > 13 else 7
                # keys[1:] starts 4 bytes past an aligned base: the scalar
                # path; keys[:n] the vector path and its tail.
                for name, k in (("aligned", keys[:n]), ("offset", keys[1:])):
                    got = digit(k, shift, bits)
                    want = fused.partition_hist_fused_plain(k, shift=shift,
                                                            bits=bits)
                    ok = all(torch.equal(a, b) for a, b in zip(got, want))
                    if not ok or n > 4099:
                        print(f"A n={n} bits={bits} {name} "
                              f"{' '.join(defines)}: "
                              f"{'bit-exact' if ok else 'FAIL'}", flush=True)
                    assert ok, (n, bits, name, defines)
    print("A: every (n, bits, alignment) case bit-exact", flush=True)


def check_e_wide() -> None:
    for p in (1 << 17, 1 << 18, (1 << 17) + 5):
        pid = torch.randint(-3, p + 3, (1 << 20,), dtype=torch.int32,
                            device="cuda")
        ok = torch.equal(partition_hist.radix_hist(pid, num_parts=p),
                         partition_hist.radix_hist_plain(pid, num_parts=p))
        print(f"E n=2^20 P={p}: {'bit-exact' if ok else 'FAIL'}", flush=True)
        assert ok, p


def time_h(probe: bool) -> None:
    shape = (4, 8, 256, 64, 64, 64)
    bs, nc, q, h, p, n = shape
    args = h_inputs(shape, torch.bfloat16, 98)
    nbytes = sum(t.numel() * t.element_size() for t in args) + \
        bs * nc * q * h * p * 4
    flops = 2.0 * bs * nc * (q * (q + 1) // 2) * (n + h * p)
    bound = max(nbytes / HBM, flops / 989e12) * 1e3
    rows = [("wgmma", ())]
    if probe:
        rows += [("wgmma", H_SINGLE_W), ("cuda_cores", ())]
        rows += [("wgmma", d) for d in H_PROBES]
    for variant, defines in rows:
        ms = cuda_ms(functools.partial(h_build(defines), *args,
                                       variant=variant))
        print(f"H time x {shape[:5]} N {n} bf16 {variant} "
              f"{' '.join(defines)}: {ms:.5f} ms, bound {bound:.6f} ms "
              f"(bytes), {bound / ms:.3f} of it", flush=True)
    if probe:
        stamps_h(args)
    x, dt, b, c, a = args

    def lib():
        dth = dt.permute(0, 1, 3, 2)
        cs = torch.cumsum(dth * a[:, None], dim=-1)
        tril = torch.tril(torch.ones(q, q, dtype=torch.bool, device="cuda"))
        decay = torch.exp(cs[..., :, None] - cs[..., None, :]).masked_fill(
            ~tril, 0.0)
        g = torch.matmul(c.float(), b.float().transpose(-1, -2))
        return torch.matmul(g[:, :, None] * decay * dth[..., None, :],
                            x.float().permute(0, 1, 3, 2, 4))
    if probe:  # the same bytes moved by PyTorch's own kernels
        yy = torch.empty(x.shape, dtype=torch.float32, device="cuda")
        print(f"H yardsticks: x.float() (reads x, writes Y's bytes) "
              f"{cuda_ms(lambda: x.float()):.5f} ms, Y.fill_(1) "
              f"{cuda_ms(lambda: yy.fill_(1.0)):.5f} ms", flush=True)
    plain = cuda_ms(lambda: kssd.ssd_intra_chunk_plain(*args), reps=5)
    print(f"H time plain {plain:.5f} ms, composite library "
          f"{cuda_ms(lib, reps=5):.5f} ms", flush=True)


def stamps_h(args) -> None:
    """The -DSSD_PROBE=7 build: clock64() stamps of block 0's two consumer
    warpgroups over its first heads (the cycles each part of a head
    takes; the slots are listed at STAMPS in csrc/ssd_intra_chunk.cu)."""
    y = h_build(H_STAMPS)(*args, variant="wgmma")
    torch.cuda.synchronize()
    h, p = args[0].shape[3], args[0].shape[4]
    names = ["X wait"]
    parts = [(0, 2)]
    for t in range(2):
        sb = 3 + 12 * t
        names += [f"t{t} S0", f"t{t} W0", f"t{t} pack0", f"t{t} S1",
                  f"t{t} W1", f"t{t} WX0 wait", f"t{t} pack1",
                  f"t{t} step1", f"t{t} step2", f"t{t} last WX",
                  f"t{t} Y stores"]
        parts += [(sb, sb + 1), (sb + 1, sb + 2), (sb + 2, sb + 3),
                  (sb + 3, sb + 4), (sb + 4, sb + 5), (sb + 5, sb + 6),
                  (sb + 6, sb + 7), (sb + 7, sb + 8), (sb + 8, sb + 9),
                  (sb + 9, sb + 10), (sb + 10, sb + 11)]
    for w in range(2):
        st = y[0, 0, w].reshape(-1)[:16 * 32 * 2].contiguous().view(
            torch.int64).view(16, 32).cpu().numpy().astype(np.float64)
        ok = st[:, 0] > 0
        total = np.diff(st[ok, 0]).mean()
        segs = []
        for n, (a, b) in zip(names, parts):
            # A slot the head did not reach holds whatever Y held.
            d = st[:, b] - st[:, a]
            sel = ok & (st[:, a] > 0) & (d >= 0) & (d < 1e6)
            sel[0] = False   # the first head also waits for C and B
            if sel.any():
                segs.append(f"{n} {np.mean(st[sel, b] - st[sel, a]):.0f}")
        print(f"H stamps warpgroup {w}: head {total:.0f} cycles; "
              + ", ".join(segs), flush=True)


def time_a(probe: bool) -> None:
    n = 1 << 24
    keys = torch.from_numpy(np.random.default_rng(6).integers(
        -2**31, 2**31, n).astype(np.int32)).cuda()
    for bits in (7, 6, 2, 1):
        builds = [()]
        if probe:
            builds += [A_MATCH] if bits <= 3 else list(A_PROBES)
        for defines in builds:
            ms = cuda_ms(functools.partial(a_build(defines), keys, 0,
                                           bits))
            print(f"A time n=2^24 bits={bits} {' '.join(defines)}: "
                  f"{ms:.5f} ms, bound {8 * n / HBM * 1e3:.6f} ms (bytes), "
                  f"{8 * n / HBM * 1e3 / ms:.3f} of it", flush=True)
        pid = fused.partition_hist_fused(keys, shift=0, bits=bits)[0]
        lib = cuda_ms(lambda: torch.bincount(pid, minlength=1 << bits))
        plain = cuda_ms(lambda: fused.partition_hist_fused_plain(
            keys, shift=0, bits=bits), reps=5)
        print(f"A time n=2^24 bits={bits}: plain {plain:.5f} ms, "
              f"torch.bincount of the pids {lib:.5f} ms", flush=True)
    if probe:
        print(f"A yardstick: keys.clone() (the same bytes) "
              f"{cuda_ms(lambda: keys.clone()):.5f} ms", flush=True)


def a_build(defines):
    """Kernel A's function ``(keys, shift, bits) -> (pid, hist)``: the
    wrapper every path calls, or the launch of a probing build with
    ``defines`` (counted among the library's launches)."""
    if not defines:
        return lambda keys, shift, bits: fused.partition_hist_fused(
            keys, shift=shift, bits=bits)
    k = _build.kernel("partition_hist_fused", "partition_hist_fused", PTR,
                      PTR, PTR, I64, I32, I32, PTR, defines=defines)

    def run(keys, shift, bits):
        pid = torch.empty_like(keys)
        hist = torch.empty(1 << bits, dtype=torch.int32, device=keys.device)
        _build.launch(k, keys.device, keys.data_ptr(), pid.data_ptr(),
                      hist.data_ptr(), keys.shape[0], shift, bits)
        return pid, hist
    return run


def h_build(defines):
    """Kernel H's function ``(x, dt, b, c, a, *, variant) -> y``, as
    ``a_build`` gives A's."""
    if not defines:
        return kssd.ssd_intra_chunk
    k = _build.kernel("ssd_intra_chunk", "ssd_intra_chunk", *[PTR] * 6,
                      *[I64] * 5, I32, I32, PTR, defines=defines)

    def run(x, dt, b, c, a, *, variant):
        bs, nc, q, h, p = x.shape
        y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        _build.launch(k, x.device, x.data_ptr(), dt.data_ptr(), b.data_ptr(),
                      c.data_ptr(), a.data_ptr(), y.data_ptr(), bs * nc, q,
                      h, p, b.shape[-1], kssd._DTYPES[x.dtype],
                      kssd.VARIANTS.index(variant), variant=variant)
        return y
    return run


def e_build(defines):
    """Kernel E's function ``(pid, num_parts) -> hist``, as ``a_build``
    gives A's."""
    if not defines:
        return lambda pid, p: partition_hist.radix_hist(pid, num_parts=p)
    k = _build.kernel("radix_hist", "radix_hist", PTR, PTR, I64, I64, PTR,
                      defines=defines)

    def run(pid, p):
        hist = torch.empty(p, dtype=torch.int32, device=pid.device)
        _build.launch(k, pid.device, pid.data_ptr(), hist.data_ptr(),
                      pid.shape[0], p)
        return hist
    return run


def f_build(defines):
    """Kernel F's function ``(table_keys, table_rids, probe_keys) ->
    rids``, as ``a_build`` gives A's."""
    if not defines:
        return pprobe.probe
    k = _build.kernel("partitioned_probe", "partitioned_probe", *[PTR] * 4,
                      I64, I64, I64, PTR, defines=defines)

    def run(tk, tr, pk):
        out = torch.empty(pk.shape, dtype=torch.int32, device=pk.device)
        _build.launch(k, pk.device, tk.data_ptr(), tr.data_ptr(),
                      pk.data_ptr(), out.data_ptr(), tk.shape[0],
                      tk.shape[1], pk.shape[1])
        return out
    return run


def e_pids(n: int, p: int, clustered: bool, seed: int) -> torch.Tensor:
    """n + 1 pids: uniform in [-2, P + 2), or ``clustered_pids`` (sorted
    runs with -1, P and P + 1 inside them)."""
    if clustered:
        return clustered_pids(n + 1, p, seed=seed, device="cuda")
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-2, p + 2, n + 1)
                            .astype(np.int32)).cuda()


def check_e(probe: bool) -> None:
    builds = [()] + (list(E_PROBES) if probe else [])
    for defines in builds:
        hist = e_build(defines)
        for n in E_SIZES:
            for p in E_PARTS:
                for clustered in (False, True):
                    base = e_pids(n, p, clustered, n + p)
                    for name, pid in (("aligned", base[:n]),
                                      ("offset", base[1:])):
                        got = hist(pid, p)
                        want = partition_hist.radix_hist_plain(pid,
                                                               num_parts=p)
                        ok = torch.equal(got, want)
                        assert ok, (n, p, clustered, name, defines)
        print(f"E {' '.join(defines) or 'default'}: every (n, P, order, "
              "alignment) case bit-exact", flush=True)


def time_e(probe: bool) -> None:
    n, p = 1 << 24, 1 << 13
    bound = (4 * n + 4 * p) / HBM * 1e3
    gen = torch.Generator(device="cuda").manual_seed(3)
    for clustered in (False, True):
        pid = torch.randint(0, p, (n,), generator=gen, dtype=torch.int32,
                            device="cuda")
        if clustered:
            pid = torch.sort(pid).values
        what = "clustered" if clustered else "uniform"
        builds = [()] + (list(E_PROBES) if probe else [])
        for defines in builds:
            run = functools.partial(e_build(defines), pid, p)
            ms, gms = cuda_ms(run), graph_ms(run)
            print(f"E time n=2^24 P=2^13 {what} {' '.join(defines)}: "
                  f"{ms:.5f} ms back to back, {gms:.5f} ms in a CUDA graph; "
                  f"bound {bound:.6f} ms (bytes), {bound / gms:.3f} of it",
                  flush=True)
        lib = cuda_ms(lambda: torch.bincount(pid, minlength=p))
        plain = cuda_ms(lambda: partition_hist.radix_hist_plain(
            pid, num_parts=p), reps=5)
        print(f"E time n=2^24 P=2^13 {what}: plain {plain:.5f} ms, "
              f"torch.bincount {lib:.5f} ms", flush=True)
    if probe:
        # The global-memory path (2^17 bins) on clustered pids, where run
        # merging spares runs of equal atomics on one address.
        wide = torch.sort(torch.randint(0, 1 << 17, (n,), generator=gen,
                                        dtype=torch.int32,
                                        device="cuda")).values
        ms = graph_ms(lambda: partition_hist.radix_hist(wide,
                                                        num_parts=1 << 17))
        print(f"E time n=2^24 P=2^17 clustered: {ms:.5f} ms in a CUDA graph",
              flush=True)
        small = pid[:1 << 12]
        print(f"E yardsticks: pid.amax() (reads the same bytes) "
              f"{graph_ms(lambda: pid.amax()):.5f} ms, pid.clone() (reads "
              f"and writes them) {graph_ms(lambda: pid.clone()):.5f} ms; E at "
              f"n = 2^12, P = 2^13 (its fixed cost) "
              f"{graph_ms(lambda: partition_hist.radix_hist(small, num_parts=p)):.5f}"
              f" ms in a CUDA graph, "
              f"{cuda_ms(lambda: partition_hist.radix_hist(small, num_parts=p)):.5f}"
              " ms back to back (the host's time per call)", flush=True)


def f_layouts():
    """(name, table_keys, table_rids, probe_keys) on the card: random
    layouts with sorted rows and with each row permuted, one 4 bytes past
    16-byte alignment, and build_partitioned_table's layouts of unique and
    negative build keys (rows [non-negative][negative][INT_MAX pads])."""
    for p, k, m in F_CHECK:
        for order in ("sorted", "unsorted"):
            yield (f"P={p} K={k} M={m} {order}", *random_layout(
                p, k, m, seed=p + k, device="cuda",
                sorted_rows=order == "sorted"))
    p, k, m = 64, 36, 100
    tk, tr, pk = random_layout(p, k, m, seed=5, device="cuda")

    def offset(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)
    yield f"P={p} K={k} M={m} offset", offset(tk), offset(tr), offset(pk)
    rng = np.random.default_rng(9)
    for kind, n in (("unique", 1 << 16), ("negative", 1 << 16)):
        keys = (rng.permutation(n) if kind == "unique"
                else rng.integers(-n, n, n))
        build = Relation(torch.arange(n, dtype=torch.int32, device="cuda"),
                         torch.from_numpy(keys.astype(np.int32)).cuda())
        probe = uniform_relation(n, key_range=n, seed=4, device="cuda")
        probe = Relation(probe.rid, probe.key - n // 2)
        tk, tr, qk, _ = pops.build_partitioned_table(build, probe,
                                                     total_bits=7)
        yield f"build_partitioned_table {kind} 2^16", tk, tr, qk


def check_f(probe: bool) -> None:
    builds = [()] + (list(F_PROBES) if probe else [])
    layouts = list(f_layouts())
    for defines in builds:
        probe_fn = f_build(defines)
        for name, tk, tr, pk in layouts:
            got = probe_fn(tk, tr, pk)
            ok = torch.equal(got, pprobe.probe_plain(tk, tr, pk))
            if not ok or not defines:
                print(f"F {name} {' '.join(defines)}: "
                      f"{'bit-exact' if ok else 'FAIL'}", flush=True)
            assert ok, (name, defines)
        print(f"F {' '.join(defines) or 'default'}: every layout "
              "bit-exact", flush=True)


def f_path_layout():
    """Path F's layout: unique(2^24) x uniform(2^24) at 13 bits."""
    n = 1 << 24
    build = unique_relation(n, seed=1, device="cuda")
    probe = uniform_relation(n, seed=2, device="cuda")
    tk, tr, qk, _ = pops.build_partitioned_table(build, probe, total_bits=13)
    return tk, tr, qk


def time_f(probe: bool) -> None:
    tk, tr, qk = f_path_layout()
    (p, k), m = tk.shape, qk.shape[1]
    hits = int((pprobe.probe(tk, tr, qk) >= 0).sum())
    bound = (p * k + 2 * p * m + hits) * 4 / HBM * 1e3
    builds = [()] + (list(F_PROBES) if probe else [])
    for defines in builds:
        run = functools.partial(f_build(defines), tk, tr, qk)
        ms, gms = cuda_ms(run), graph_ms(run)
        print(f"F time P={p} K={k} M={m} {' '.join(defines)}: {ms:.5f} ms "
              f"back to back, {gms:.5f} ms in a CUDA graph; bound "
              f"{bound:.6f} ms (bytes), {bound / gms:.3f} of it", flush=True)
    lib = cuda_ms(lambda: probe_ref(tk, tr, qk), reps=5)
    print(f"F time: probe_ref (searchsorted + 2 gathers) {lib:.5f} ms",
          flush=True)
    if probe:
        print(f"F yardstick: tk.clone() + qk.clone() (reads and writes "
              f"{2 * (tk.numel() + qk.numel()) * 4 / 1e6:.0f} MB, about F's "
              f"bytes) {graph_ms(lambda: (tk.clone(), qk.clone())):.5f} ms "
              "in a CUDA graph",
              flush=True)


KERNELS = {"G": "flash_attn", "B": "radix_scatter", "H": "ssd_intra_chunk",
           "A": "partition_hist_fused", "E": "radix_hist",
           "F": "partitioned_probe"}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--only", default="G,B,H,A,E,F")
    args = ap.parse_args()
    only = [k.strip() for k in args.only.split(",") if k.strip()]
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, "| torch", torch.__version__, "cuda", torch.version.cuda)
    t0 = time.perf_counter()
    names = [KERNELS[k] for k in only]
    if "B" in only and "E" not in only:
        names.append("radix_hist")
    probes = {"E": ("radix_hist", E_PROBES),
              "F": ("partitioned_probe", F_PROBES),
              "A": ("partition_hist_fused", A_PROBES + (A_MATCH,)),
              "H": ("ssd_intra_chunk", H_PROBES + (H_SINGLE_W, H_STAMPS))}
    prebuild([(n, ()) for n in names] +
             [(probes[k][0], d) for k in only if args.probe and k in probes
              for d in probes[k][1]])
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    if args.ptxas:
        for name in names:
            ptxas(name)
    checks = {"G": lambda: check_g(), "B": lambda: (check_b(), check_e_wide()),
              "H": lambda: check_h(args.probe), "A": lambda: check_a(args.probe),
              "E": lambda: check_e(args.probe),
              "F": lambda: check_f(args.probe)}
    times = {"G": lambda: time_g(), "B": lambda: time_b(),
             "H": lambda: time_h(args.probe), "A": lambda: time_a(args.probe),
             "E": lambda: time_e(args.probe), "F": lambda: time_f(args.probe)}
    for k in only:
        checks[k]()
    if not args.quick:
        for k in only:
            times[k]()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
