"""Where the time of the port's LM serving goes, on one CUDA card.

    python3 tools/profile_torch_lm.py [--arch zamba2_1_2b] [--batch 4]
        [--prompt-len 2048] [--steps 8] [--trace-dir reports/torch]
        [--moe-impl dense|sorted]
    python3 tools/profile_torch_lm.py --arch whisper_large_v3 --batch 8 \\
        --prompt-len 4 --steps 31

Builds the config at full width (random weights, seed 0; an MoE config
under ``--moe-impl``, by default its own dispatch engine; an
encoder-decoder config with stub frames drawn as the serve CLI draws
them), warms up with one ``ServeEngine.generate``, then traces with
``torch.profiler``:

* an encoder-decoder config's encoder (``_encode``) alone;
* one prefill (``make_prefill_step``) of ``batch`` x ``prompt-len``
  tokens (with the encoder);
* ``steps`` decode steps (``make_decode_step``) against the prefill's
  cache.

With ``--train`` it profiles training instead: one step of
``make_train_step`` at ``batch`` x ``seq-len`` tokens in one microbatch
(the config's remat) after one warm-up step, traced whole; then one
more step without the profiler, split with CUDA events
recorded around its parts into the forward, each unit's recompute in
the backward, G's and H's plain backward, the rest of the backward, and
the optimizer:

    python3 tools/profile_torch_lm.py --train [--arch zamba2_1_2b]
        [--batch 2] [--seq-len 4096]

For each it prints the wall time (host clock around work that ends in a
synchronize, under the profiler), the device time summed over kernels,
the busy share (device time over wall time; the port runs on one
stream), the kernel launches, the device time split into matmuls, kernel
G and the rest (elementwise and copies), and the 12 kernels with the
most device time.  Chrome traces go to
``<trace-dir>/lm_{encode,prefill,decode}_trace.json``.  Prints the card's
name and power limit first.  Needs a CUDA card.
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
from repro_torch.models.params import torch_dtype  # noqa: E402
from repro_torch.serve.engine import (ServeEngine, grow_cache,  # noqa: E402
                                      make_decode_step, make_prefill_step)


# Substrings of the kernel names that cuBLAS and CUTLASS give matrix
# products (and matrix-vector products) on Hopper; G's kernels are
# csrc/flash_attn.cu's flash_fwd_{wgmma,bf16,f32}.
MATMUL_NAMES = ("gemm", "gemv", "xmma", "cutlass", "nvjet", "cublas")


def split_of(rows, dev_us) -> dict:
    """Device ms of ``rows`` (kernel rows) as matmuls, G, H and the
    rest."""
    out = {"matmul": 0.0, "flash_attn": 0.0, "ssd_intra_chunk": 0.0,
           "other": 0.0}
    for e in rows:
        name = e.key.lower()
        kind = ("flash_attn" if "flash_fwd" in name else
                "ssd_intra_chunk" if "ssd_intra" in name else
                "matmul" if any(m in name for m in MATMUL_NAMES) else
                "other")
        out[kind] += dev_us(e) / 1e3
    return out


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
    split = {k: v / per for k, v in split_of(rows, dev_us).items()}
    out = {"wall_ms": wall_ms / per, "busy_ms": busy_ms / per,
           "busy_share": busy_ms / wall_ms, "launches": launches / per,
           "split_ms": split}
    print(f"{name}: wall {out['wall_ms']:.3f} ms (host clock, under the "
          f"profiler), device busy {out['busy_ms']:.3f} ms, busy share "
          f"{out['busy_share']:.3f}, {out['launches']:.0f} kernel launches"
          f"{' per step' if per > 1 else ''}; device ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    for e in rows[:12]:
        print(f"  {dev_us(e) / 1e3 / per:9.3f} ms  x{e.count / per:<7g} "
              f"{e.key[:90]}")
    return out


class Parts:
    """CUDA events around the parts of a train step: each wrapped function
    adds the device time between its start and end to its part."""

    def __init__(self):
        self.spans = {}
        self.phase = "forward"

    def wrap(self, module, name: str, part):
        fn = getattr(module, name)

        def wrapper(*args, **kw):
            label = part() if callable(part) else part
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                return fn(*args, **kw)
            finally:
                # A recompute stops early by raising once it has what the
                # backward needs.
                end.record()
                self.spans.setdefault(label, []).append((start, end))
        setattr(module, name, wrapper)

    def ms(self) -> dict:
        torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v)
                for k, v in self.spans.items()}


def profile_train(args, dev) -> int:
    """``--train``: one traced train step, then one split into its
    parts."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.flash_attn import ops as gops
    from repro_torch.kernels.ssd import ops as hops
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train import step as tstep

    cfg = get_config(args.arch)
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt = AdamWConfig(lr=1e-3)
    state = adamw_init(params, opt)
    step = tstep.make_train_step(cfg, None, None, opt)
    ds = SyntheticLM(cfg.vocab_size, args.seq_len, args.batch)

    def batch(i):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in ds.batch(i).items()}

    params, state, _ = step(params, state, batch(0))      # warm-up
    print(f"{cfg.name}: train step of {args.batch} x {args.seq_len} tokens "
          f"in one microbatch, remat {cfg.remat!r}")
    b = batch(1)
    traced("train_step", lambda: step(params, state, b),
           Path(args.trace_dir))
    # The parts, from a step run without the profiler: the forward is
    # loss_fn; a unit's forward run from inside the backward is its
    # recompute.
    parts = Parts()
    loss_fn = tstep.loss_fn

    def forward(*a, **kw):
        parts.phase = "forward"
        out = loss_fn(*a, **kw)
        parts.phase = "backward"
        return out
    tstep.loss_fn = forward
    parts.wrap(tstep, "loss_fn", "forward")
    parts.wrap(tfm, "_unit_fwd", lambda: ("unit forward"
                                          if parts.phase == "forward"
                                          else "recompute"))
    parts.wrap(gops, "flash_attention_bwd", "G backward (plain)")
    parts.wrap(hops, "ssd_intra_chunk_bwd", "H backward (plain)")
    parts.wrap(tstep, "adamw_update", "optimizer")
    parts.wrap(tstep, "loss_and_grads", "forward + backward")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, m = step(params, state, b)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    ms = parts.ms()
    fb = ms.pop("forward + backward")
    ms["backward (rest)"] = fb - ms["forward"] - ms.get("recompute", 0.0) \
        - ms.get("G backward (plain)", 0.0) \
        - ms.get("H backward (plain)", 0.0)
    print(f"unprofiled step: {wall:.3f} ms (host clock); parts (device ms "
          f"between CUDA events, summed; the forward includes its units): "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    print(f"peak device memory {torch.cuda.max_memory_allocated()} B; "
          f"loss {float(m['loss']):.6f}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2_1_2b")
    ap.add_argument("--batch", type=int,
                    help="sequences: 4 to serve, 2 to train")
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--trace-dir", default="reports/torch")
    ap.add_argument("--moe-impl", choices=("dense", "sorted"))
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--seq-len", type=int, default=4096)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_lm: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip())
    dev = torch.device("cuda:0")
    if args.train:
        args.batch = args.batch or 2
        return profile_train(args, dev)
    args.batch = args.batch or 4
    cfg = get_config(args.arch)
    if args.moe_impl:
        cfg = dataclasses.replace(cfg, moe_impl=args.moe_impl)
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    b, p, steps = args.batch, args.prompt_len, args.steps
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, p), dtype=np.int32)).to(dev)
    frames = None
    if cfg.encoder:
        frames = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder.num_frames, cfg.d_model)) * 0.02).to(
                dev, torch_dtype(cfg.dtype))
    ServeEngine(cfg, params, max_seq=p + steps + 1).generate(prompts, 4,
                                                             frames)
    print(f"{cfg.name} ({cfg.moe_impl if cfg.moe else 'no MoE'}): batch "
          f"{b}, prompt {p}, {steps} decode steps")
    prefill = make_prefill_step(cfg, None, None)
    step = make_decode_step(cfg, None, None)
    held = {}

    def run_prefill():
        held["logits"], held["cache"] = prefill(
            params, {"tokens": prompts, "enc_frames": frames})

    if cfg.encoder:
        traced("encode", lambda: tfm._encode(params, cfg, frames),
               Path(args.trace_dir))
    traced("prefill", run_prefill, Path(args.trace_dir))
    cache = grow_cache(held["cache"], p + steps + 1)
    tok = torch.argmax(held["logits"], -1).to(torch.int32)[:, None]

    def run_decode():
        t, c = tok, cache
        for n in range(p, p + steps):
            t, _, c = step(params, c, t, n)

    traced("decode", run_decode, Path(args.trace_dir), per=steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
