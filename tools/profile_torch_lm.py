"""Where the time of the port's LM serving goes, on one CUDA card.

    python3 tools/profile_torch_lm.py [--arch zamba2_1_2b] [--batch 4]
        [--prompt-len 2048] [--steps 8] [--trace-dir reports/torch]
        [--moe-impl dense|sorted]

Builds the config at full width (random weights, seed 0; an MoE config
under ``--moe-impl``, by default its own dispatch engine), warms up with
one ``ServeEngine.generate``, then traces with ``torch.profiler``:

* one prefill (``make_prefill_step``) of ``batch`` x ``prompt-len``
  tokens;
* ``steps`` decode steps (``make_decode_step``) against the prefill's
  cache.

For each it prints the wall time (host clock around work that ends in a
synchronize, under the profiler), the device time summed over kernels,
the busy share (device time over wall time; the port runs on one
stream), the kernel launches, and the 12 kernels with the most device
time.  Chrome traces go to ``<trace-dir>/lm_{prefill,decode}_trace.json``.
Prints the card's name and power limit first.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serve.engine import (ServeEngine, grow_cache,  # noqa: E402
                                      make_decode_step, make_prefill_step)


def traced(name: str, fn, trace_dir: Path, per: int = 1) -> dict:
    """Run ``fn`` once under the profiler; print and return its summary,
    with launches and times divided by ``per`` (steps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trace_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_dir / f"lm_{name}_trace.json"))

    def dev_us(e) -> float:
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))

    # Kernel rows only: an aten op's row repeats its kernels' device time.
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    launches = sum(e.count for e in rows)
    out = {"wall_ms": wall_ms / per, "busy_ms": busy_ms / per,
           "busy_share": busy_ms / wall_ms, "launches": launches / per}
    print(f"{name}: wall {out['wall_ms']:.3f} ms (host clock, under the "
          f"profiler), device busy {out['busy_ms']:.3f} ms, busy share "
          f"{out['busy_share']:.3f}, {out['launches']:.0f} kernel launches"
          f"{' per step' if per > 1 else ''}")
    for e in rows[:12]:
        print(f"  {dev_us(e) / 1e3 / per:9.3f} ms  x{e.count / per:<7g} "
              f"{e.key[:90]}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2_1_2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--trace-dir", default="reports/torch")
    ap.add_argument("--moe-impl", choices=("dense", "sorted"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_lm: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip())
    dev = torch.device("cuda:0")
    cfg = get_config(args.arch)
    if args.moe_impl:
        cfg = dataclasses.replace(cfg, moe_impl=args.moe_impl)
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    b, p, steps = args.batch, args.prompt_len, args.steps
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, p), dtype=np.int32)).to(dev)
    ServeEngine(cfg, params, max_seq=p + steps + 1).generate(prompts, 4)
    print(f"{cfg.name} ({cfg.moe_impl if cfg.moe else 'no MoE'}): batch "
          f"{b}, prompt {p}, {steps} decode steps")
    prefill, step = make_prefill_step(cfg), make_decode_step(cfg)
    held = {}

    def run_prefill():
        held["logits"], held["cache"] = prefill(params, {"tokens": prompts})

    traced("prefill", run_prefill, Path(args.trace_dir))
    cache = grow_cache(cfg, held["cache"], b, p + steps + 1, dev)
    tok = torch.argmax(held["logits"], -1).to(torch.int32)[:, None]

    def run_decode():
        t, c = tok, cache
        for n in range(p, p + steps):
            t, _, c = step(params, c, t, n)

    traced("decode", run_decode, Path(args.trace_dir), per=steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
