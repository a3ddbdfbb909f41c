"""Training entry point.

  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2_1_2b \\
      --smoke --device cpu --steps 20 --ckpt-dir /tmp/ckpt

Counterpart of ``repro/launch/train.py``, with its flags and loop:
random weights from seed 0, AdamW with a cosine schedule, the step on
``make_host_mesh()`` under ``TRAIN_RULES``, the deterministic synthetic
stream (any process can rebuild any step's batch), periodic checkpoints,
resume from the latest, a SIGTERM flush.  ``--device`` picks the device
(``cuda`` by default; it raises without a card).  Run alone, the mesh is
(1, 1) over a process group of this process (NCCL on the card, gloo on
the CPU), which ``main`` starts and ends; under ``torchrun`` it spans the
ranks torchrun started.  The JAX package's TPU compiler flags have no
counterpart here.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch
import torch.distributed as dist


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-pod-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train as the flags say; returns the last step's metrics (floats)
    and the step the run started from (``start``)."""
    args = parse_args(argv)
    started = not dist.is_initialized()
    try:
        return _train(args)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _train(args) -> dict:
    from ..checkpoint import CheckpointManager
    from ..configs import ShapeSpec, get_config, reduced
    from ..core.relation import resolve_device
    from ..core.tree import param_tree
    from ..data.pipeline import SyntheticLM, enc_frames
    from ..distributed.sharding import TRAIN_RULES
    from ..models import transformer as tfm
    from ..optim.adamw import AdamWConfig, adamw_init
    from ..train.step import make_train_step
    from .mesh import make_host_mesh

    device = resolve_device(args.device)
    cfg = get_config(args.arch.replace("-", "_"))
    if args.smoke:
        cfg = reduced(cfg)
    cfg = dataclasses.replace(cfg, train_accum=args.accum)
    shape = ShapeSpec("cli", args.seq_len, args.batch, "train")
    mesh = make_host_mesh(device=device)
    opt = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                      total_steps=args.steps)
    params = tfm.init_params(cfg, device=device)
    opt_state = adamw_init(params, opt)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M device={device} "
          f"mesh={tuple(mesh.shape)} "
          f"tokens/step={shape.global_batch * shape.seq_len}")

    step_fn = make_train_step(cfg, mesh, TRAIN_RULES, opt,
                              accum_steps=args.accum,
                              compress_pod_grads=args.compress_pod_grads)
    ds = SyntheticLM(cfg.vocab_size, shape.seq_len, shape.global_batch)
    mgr = CheckpointManager(args.ckpt_dir, save_every=args.ckpt_every) \
        if args.ckpt_dir else None

    start = 0
    if mgr:
        restored, start = mgr.restore_latest(
            {"params": param_tree(params), "opt": opt_state}, device=device)
        if restored is not None:    # params and opt_state filled in place
            print(f"resumed from step {start}")

    t0 = time.time()
    tokens_done = 0
    m = None
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in ds.batch(step).items()}
        if cfg.encoder:
            batch["enc_frames"] = enc_frames(cfg, shape.global_batch, step,
                                             device, cfg.dtype)
        params, opt_state, m = step_fn(params, opt_state, batch)
        tokens_done += shape.global_batch * shape.seq_len
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(m["loss"])       # waits for the step
            dt = time.time() - t0
            print(f"step {step:5d} loss={loss:.4f} "
                  f"gnorm={float(m['grad_norm']):.3f} "
                  f"lr={float(m['lr']):.2e} "
                  f"tok/s={tokens_done / max(dt, 1e-9):,.0f}")
        if mgr and (mgr.maybe_save(step + 1, {"params": param_tree(params),
                                              "opt": opt_state})
                    and mgr.preempted):
            print("preemption checkpoint flushed; exiting")
            break
    out = {k: float(v) for k, v in m.items()} if m is not None else {}
    if m is not None and not (mgr and mgr.preempted):
        print(f"done: {args.steps} steps, final loss {out['loss']:.4f}")
    out["start"] = start
    return out


if __name__ == "__main__":
    main()
