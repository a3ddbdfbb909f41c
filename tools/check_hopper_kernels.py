"""Build, check and time kernels G (flash attention) and B (radix
scatter) on one CUDA card.

    python3 tools/check_hopper_kernels.py [--ptxas] [--quick]

With ``--ptxas`` it first compiles ``csrc/flash_attn.cu`` and
``csrc/radix_scatter.cu`` once more with ``nvcc -Xptxas -v`` and prints
each kernel's registers, shared memory and spills.  Then it holds G
against ``flash_attention_plain`` (2e-2 bf16, 3e-5 f32) and B against
``radix_scatter_plain`` (bit for bit) over a small grid of shapes, and
times both at the main paths' shapes beside their library calls:
G at (4, 2048, 32, 64) and (1, 2048, 2048, 32, 8, 128) bf16 causal
against ``scaled_dot_product_attention``, B at 2^24 tuples for 7 and 6
bits against a stable ``torch.sort`` + 2 gathers.  ``--quick`` stops
after the checks.  Prints the card's name and power limit first.  Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attn import flash_attn as fa  # noqa: E402
from repro_torch.kernels.partition_hist import reorder  # noqa: E402

G_CHECK = ((1, 128, 128, 2, 2, 64, True), (1, 128, 128, 2, 2, 128, True),
           (2, 256, 256, 4, 2, 64, True), (1, 128, 384, 8, 8, 128, False),
           (1, 1000, 1000, 8, 2, 64, True), (1, 129, 300, 4, 1, 128, False),
           (1, 1, 1, 2, 1, 64, True), (4, 2048, 2048, 32, 32, 64, True),
           (1, 2048, 2048, 32, 8, 128, True))
B_CHECK = ((4095, 7), (4097, 6), (3 * 4096 + 17, 1), (1_000_003, 7),
           (1 << 22, 11), (1 << 20, 13))


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, "| torch", torch.__version__, "cuda", torch.version.cuda)
    t0 = time.perf_counter()
    _build.build_all(("flash_attn", "radix_scatter"))
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    if args.ptxas:
        for name in ("flash_attn", "radix_scatter"):
            ptxas(name)
    check_b()
    check_g()
    if not args.quick:
        time_b()
        time_g()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
