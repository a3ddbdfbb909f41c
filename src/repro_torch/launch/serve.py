"""Serving driver: batched greedy generation with random weights.

  python -m repro_torch.launch.serve --arch zamba2_1_2b --batch 4 \\
      --prompt-len 2048 --new-tokens 32
  python -m repro_torch.launch.serve --arch mamba2_2_7b --smoke \\
      --device cpu
  python -m repro_torch.launch.serve --arch whisper_large_v3 --smoke \\
      --device cpu

Counterpart of ``repro/launch/serve.py``.  Weights come from
``init_params`` seeded 0 and prompts from ``numpy.random.default_rng(0)``;
an encoder-decoder config's stub frame embeddings (B, F, d_model) are
drawn from the same generator right after the prompts, as
``standard_normal * 0.02`` in the model's dtype.
The first ``generate`` is a warm-up (it builds the kernels); the second is
timed, with CUDA events on a card and the host clock on the CPU, and the
line names the device it ran on.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.relation import resolve_device
    from repro_torch.models import transformer as tfm
    from repro_torch.models.params import torch_dtype
    from repro_torch.serve.engine import ServeEngine

    dev = resolve_device(args.device)
    cfg = get_config(args.arch.replace("-", "_"))
    if args.smoke:
        cfg = reduced(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = tfm.init_params(cfg, gen)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len),
        dtype=np.int32)).to(dev)
    enc = None
    if cfg.encoder:
        enc = torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.encoder.num_frames, cfg.d_model)) * 0.02).to(
                dev, torch_dtype(cfg.dtype))
    engine = ServeEngine(cfg, params,
                         max_seq=args.prompt_len + args.new_tokens + 8)
    engine.generate(prompts, args.new_tokens, enc)         # warm-up
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = engine.generate(prompts, args.new_tokens, enc)
        end.record()
        end.synchronize()
        secs = start.elapsed_time(end) / 1e3
        where = torch.cuda.get_device_name(dev)
    else:
        t0 = time.perf_counter()
        out = engine.generate(prompts, args.new_tokens, enc)
        secs = time.perf_counter() - t0
        where = "cpu (host clock)"
    n_new = args.batch * args.new_tokens
    print(f"arch={cfg.name} device={where} generated {tuple(out.shape)} in "
          f"{secs:.3f}s ({n_new / secs:.1f} tok/s after one warm-up)")
    print("sample:", out[0, :16].cpu().numpy())


if __name__ == "__main__":
    main()
