"""Dry-run: run one step of every (arch x shape x mesh) cell on a fake
cluster, with no card and no kernel build.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell with XLA on 512 forced host devices.  Here each cell runs one real
step (train: parameters, AdamW state and batch; prefill; decode:
parameters, ``abstract_cache`` and tokens) on DTensors over the fake
process group (``torch.testing._internal.distributed.fake_pg``: one rank
of 256 or 512, collectives that move nothing) whose local shards are
meta tensors (shapes and dtypes, no data; kernels G, H and E give their
outputs' shapes through their custom ops' fake kernels).  (Not
``FakeTensorMode``: under it, DTensor's redistribution planner calls
``item()`` on a mesh coordinate made inside the mode and fails on a
strided shard, as the sequence-parallel residual flattened into a matmul
gives.)  That shows that every sharding is
coherent at production scale and measures, per device:

  * ``memory.argument_bytes``: the local shard bytes of the step's inputs;
    ``memory.temp_bytes``: the peak over them, from
    ``torch.distributed._tools.mem_tracker.MemTracker``;
  * ``flops_per_device``: the local ops' FLOPs, counted with
    ``torch.utils.flop_counter``'s formulas (kernels G and H by the
    formulas registered below);
  * ``collectives``: one record ``{kind, dtype, bytes, group}`` per
    collective that DTensor issues, seen through
    ``torch.distributed.tensor.debug.CommDebugMode``; ``bytes`` is the
    per-device result size, as the JAX package parses it from the HLO.

The JAX package's ``cost_analysis_dict`` and ``parse_collectives`` read
XLA's compiled objects and have no counterpart: the modes above replace
them.  Keys that only XLA has (``code_bytes``, ``compile_s``,
``bytes_accessed_per_device``) are null, with the reason in
``null_reasons``.  The port runs no scan, so ``flops_per_device`` counts
the whole model; ``per_unit_flops`` comes from the 1- and 2-unit
``_variant``s, as the JAX package extrapolates.

Reports land in reports/dryrun_torch/<arch>__<shape>__<mesh>.json.

Usage (a process of its own: it starts the fake process group):
  python -m repro_torch.launch.dryrun --arch zamba2_1_2b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--and-multi-pod]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from ..configs import SHAPES, all_configs, get_config, runnable
from ..distributed.sharding import (SERVE_RULES, TRAIN_RULES, ShardingRules,
                                    make_sharding, mesh_shape)
from ..distributed import sharding as dsh
from .mesh import HW, make_production_mesh

REPORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "reports", "dryrun_torch")

_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float16: "f16",
                torch.float32: "f32", torch.float64: "f64",
                torch.int32: "s32", torch.int64: "s64", torch.int8: "s8",
                torch.uint8: "u8", torch.bool: "pred"}

NULL_REASONS = {
    "compile_s": "nothing is compiled: each op runs eagerly on fake tensors",
    "code_bytes": "no compiled executable, so no generated code",
    "bytes_accessed_per_device": "XLA's cost analysis has no counterpart; "
                                 "only FLOPs are counted",
}


def collective_link_bytes(colls: list[dict]) -> float:
    """Per-chip bytes crossing links (ring cost model, DESIGN.md §8).

    ``bytes`` is the op's per-device RESULT size, so ring factors differ
    per kind: an all-gather result is the big gathered buffer (receive
    (n-1)/n of it), a reduce-scatter result is the small shard (send (n-1)
    shards), an all-reduce moves 2(n-1)/n of its buffer.
    """
    total = 0.0
    for c in colls:
        n = max(c["group"], 2)
        factor = {"all-gather": (n - 1) / n,
                  "reduce-scatter": (n - 1),
                  "all-to-all": (n - 1) / n,
                  "collective-permute": 1.0,
                  "all-reduce": 2 * (n - 1) / n}[c["kind"]]
        total += c["bytes"] * factor
    return total


def _by_kind(colls):
    out: dict = {}
    for c in colls:
        k = out.setdefault(c["kind"], {"count": 0, "bytes": 0})
        k["count"] += 1
        k["bytes"] += c["bytes"]
    return out


# --------------------------------------------------------------------------
# What the fake run is measured with.
# --------------------------------------------------------------------------

def _register_kernel_flops() -> None:
    """FLOP formulas of kernels G and H (custom ops, which the counter does
    not know): G as torch counts SDPA (both products over all Sq x Sk),
    H as its two products per chunk, C B^T and the masked (Q, Q) by X."""
    from torch.utils.flop_counter import flop_registry, register_flop_formula

    from ..kernels.flash_attn import ops as g_ops  # noqa: F401 (the op)
    from ..kernels.ssd import ops as h_ops  # noqa: F401 (the op)

    g = torch.ops.repro_torch.flash_attention_fwd
    h = torch.ops.repro_torch.ssd_intra_chunk_fwd
    if g in flop_registry:
        return

    @register_flop_formula(g)
    def _(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs):
        b, sq, nh, d = q_shape
        return 4 * b * nh * sq * k_shape[1] * d

    @register_flop_formula(h)
    def _(x_shape, dt_shape, b_shape, c_shape, a_shape, *args,
          out_shape=None, **kwargs):
        b, nc, q, nh, p = x_shape
        return 2 * b * nc * q * q * (b_shape[-1] + nh * p)


def comm_counter():
    """A ``CommDebugMode`` that counts the collectives DTensor issues
    (``get_comm_counts``, ``get_total_counts``) without its per-module
    tracking, whose hooks fail under activation checkpointing and across
    microbatches (torch 2.11 and 2.13)."""
    from collections import defaultdict

    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils._python_dispatch import TorchDispatchMode

    class FlatCommDebugMode(CommDebugMode):
        def __enter__(self):
            self.comm_counts.clear()
            self.comm_module_counts.clear()
            self.comm_module_counts[""] = {"forward": defaultdict(int),
                                           "backward": defaultdict(int)}
            self.comm_module_operation_counts.clear()
            self.advanced_module_tracker.name = ""
            self.advanced_module_tracker.module_parents_dict = {"": []}
            TorchDispatchMode.__enter__(self)
            return self

        def __exit__(self, *args):
            TorchDispatchMode.__exit__(self, *args)

    return FlatCommDebugMode()


def _dispatch_modes():
    """(flop counter, collective recorder): dispatch modes that let
    DTensor desugar first, so they see each rank's local ops."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    fc = torch.ops._c10d_functional
    kinds = {fc.all_gather_into_tensor: "all-gather",
             fc.all_reduce: "all-reduce",
             fc.reduce_scatter_tensor: "reduce-scatter",
             fc.all_to_all_single: "all-to-all"}

    class LocalFlops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(t is DTensor for t in types):
                return NotImplemented
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None and not _propagating():
                self.flops += formula(*args, **kwargs, out_val=out)
            return out

    class Collectives(type(comm_counter())):
        def __init__(self):
            super().__init__()
            self.records: list[dict] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            kind = kinds.get(getattr(func, "_overloadpacket", None))
            if kind is not None and out is not NotImplemented:
                from torch.distributed.distributed_c10d import \
                    _resolve_process_group
                group = _resolve_process_group(args[-1]).size()
                self.records.append({
                    "kind": kind, "dtype": _DTYPE_NAMES.get(out.dtype,
                                                            str(out.dtype)),
                    "bytes": out.numel() * out.element_size(),
                    "group": group})
            return out

    return LocalFlops(), Collectives()


def _propagating() -> bool:
    """Whether an op runs inside DTensor's sharding propagation, which
    runs ops on fake tensors to learn output shapes (no rank runs them)."""
    from torch._guards import active_fake_mode

    return active_fake_mode() is not None


def _local_tensors(tree) -> list[torch.Tensor]:
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _local_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _local_tensors(v)]
    if isinstance(tree, torch.nn.Module):
        return _local_tensors(list(tree.parameters()))
    if isinstance(tree, DTensor):
        return [tree.to_local()]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _storage_key(t: torch.Tensor):
    return t.untyped_storage()._cdata


# --------------------------------------------------------------------------
# Cells.
# --------------------------------------------------------------------------

def start_fake_group(world: int) -> None:
    """The default process group: the fake backend, this process rank 0 of
    ``world`` (a group of another size is replaced)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def fake_production_mesh(*, multi_pod: bool = False):
    start_fake_group(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, devices="cpu")


def serve_rules_for(cfg, mesh, hw=HW) -> ShardingRules:
    """Replicate-vs-FSDP weights at serving time: keep FSDP ("data") on the
    weights only when TP alone cannot fit them in ``hw``'s HBM (llama4-400B
    needs it, 8B models do not)."""
    model_ways = mesh_shape(mesh).get("model", 1)
    per_dev = cfg.param_count() * 2 / model_ways
    if per_dev > 0.5 * hw["hbm_bytes"]:
        return TRAIN_RULES  # includes fsdp->data
    return SERVE_RULES


def opt_dtype_for(cfg, mesh, hw=HW) -> str:
    """bfloat16 moments when float32 states cannot fit (the 400B config)."""
    n_dev = 1
    for v in mesh_shape(mesh).values():
        n_dev *= v
    return ("bfloat16" if cfg.param_count() * 16 / n_dev
            > 0.6 * hw["hbm_bytes"] else "float32")


def _variant(cfg, k: int):
    """Same architecture with k pattern units (``per_unit_flops`` is
    F(2) - F(1))."""
    kw = {"num_layers": k * len(cfg.pattern_unit) + len(cfg.tail),
          "scan_layers": False}
    if cfg.encoder:
        from ..configs.base import EncoderCfg
        kw["encoder"] = EncoderCfg(num_layers=k,
                                   num_frames=cfg.encoder.num_frames)
    return dataclasses.replace(cfg, **kw)


def _build(cfg, shape, mesh, rules, opt_dtype, hw, accum):
    """(step thunk, its argument tree) for (cfg, shape) on ``mesh``, every
    tensor on the meta device."""
    from ..models import transformer as tfm
    from ..models.params import abstract, map_specs, shardings, torch_dtype
    from ..optim.adamw import AdamWConfig
    from ..serve.engine import (abstract_cache, make_decode_step,
                                make_prefill_step)
    from ..train.step import abstract_batch, make_train_step

    dev = "meta"
    specs = tfm.lm_specs(cfg)
    if shape.kind == "train":
        rules = rules or TRAIN_RULES
        opt = AdamWConfig(state_dtype=opt_dtype or opt_dtype_for(cfg, mesh,
                                                                 hw))
        sh = shardings(specs, mesh, rules)
        lm = tfm.LM(cfg, abstract(specs, torch_dtype(cfg.dtype),
                                  shardings_tree=sh, device=dev))
        # Every moment in the state dtype, as adamw_init makes them.
        state_specs = map_specs(
            lambda s: dataclasses.replace(s, dtype=opt.state_dtype), specs)
        mu, nu = (abstract(state_specs, device=dev, shardings_tree=sh)
                  for _ in range(2))
        state = {"mu": mu, "nu": nu,
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        batch = abstract_batch(cfg, shape, mesh, rules, device=dev)
        step = make_train_step(cfg, mesh, rules, opt, accum_steps=accum)
        return (lambda: step(lm, state, batch)), (lm, state, batch)
    rules = rules or serve_rules_for(cfg, mesh, hw)
    lm = tfm.LM(cfg, abstract(specs, torch_dtype(cfg.dtype), device=dev,
                              shardings_tree=shardings(specs, mesh, rules)))
    # MemTracker hooks every parameter's gradient; serving runs under
    # no_grad all the same.
    lm.requires_grad_(True)
    if shape.kind == "prefill":
        batch = abstract_batch(cfg, shape, mesh, rules, device=dev)
        batch.pop("labels")
        step = make_prefill_step(cfg, mesh, rules)
        return (lambda: step(lm, batch)), (lm, batch)
    cache = abstract_cache(cfg, shape.global_batch, shape.seq_len, mesh,
                           rules, device=dev)
    from ..models.params import distribute

    b = shape.global_batch
    tokens = distribute(torch.zeros((b, 1), dtype=torch.int32, device=dev),
                        make_sharding(mesh, rules, ("batch", None), (b, 1)))
    step = make_decode_step(cfg, mesh, rules)
    return (lambda: step(lm, cache, tokens, shape.seq_len - 1)), \
        (lm, cache, tokens)


def _measure(cfg, shape, mesh, rules, opt_dtype, hw, accum) -> dict:
    """One fake step of (cfg, shape): FLOPs, memory and collectives."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class Tracker(MemTracker):
        """MemTracker across microbatches: a module's stats of the last
        one are dropped when it runs again (the peak is kept).  Ops of
        DTensor's sharding propagation are not counted (torch 2.11's
        MemTracker counts their fake outputs, more on a cold cache)."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if _propagating():
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

        def _pre_fw_hook(self, module, inputs):
            try:
                super()._pre_fw_hook(module, inputs)
            except NotImplementedError:
                self.reset_mod_stats()
                super()._pre_fw_hook(module, inputs)

    run, args = _build(cfg, shape, mesh, rules, opt_dtype, hw, accum)
    arg_local = _local_tensors(args)
    arg_keys = {_storage_key(t) for t in arg_local}
    flops, comms = _dispatch_modes()
    mt = Tracker()
    mt.track_external(*arg_local)
    fallbacks = dsh.view_fallbacks
    t0 = time.time()
    with mt, comms, flops:
        out = run()
    seconds = time.time() - t0
    fallbacks = dsh.view_fallbacks - fallbacks
    peak = sum(d["Total"] for d in mt.get_tracker_snapshot("peak").values())
    outs = _local_tensors(out)
    alias = [t for t in outs if _storage_key(t) in arg_keys]
    arg_bytes = _bytes(arg_local)
    return {"seconds": seconds, "flops": float(flops.flops),
            "colls": comms.records,
            "link_bytes": collective_link_bytes(comms.records),
            "argument_bytes": arg_bytes,
            "temp_bytes": max(0, peak - arg_bytes),
            "output_bytes": _bytes(outs), "alias_bytes": _bytes(alias),
            "view_fallbacks": fallbacks}


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               opt_dtype: str | None = None, rules=None,
               extrapolate: bool = True, cfg=None, tag: str | None = None,
               hw=HW, mesh=None):
    """Run one cell's fake step; returns the report dict (the JAX
    package's keys).  ``mesh`` defaults to the fake production mesh."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = runnable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "why": why}
    _register_kernel_flops()
    mesh = mesh or fake_production_mesh(multi_pod=multi_pod)
    sizes = mesh_shape(mesh)
    mesh_name = "x".join(str(s) for s in sizes.values())
    full = _measure(cfg, shape, mesh, rules, opt_dtype, hw, cfg.train_accum)
    per_unit = 0.0
    if extrapolate and cfg.num_units > 2:
        # The variants run one microbatch, as the JAX package's do.
        f1 = _measure(_variant(cfg, 1), shape, mesh, rules, opt_dtype, hw, 1)
        f2 = _measure(_variant(cfg, 2), shape, mesh, rules, opt_dtype, hw, 1)
        per_unit = max(0.0, f2["flops"] - f1["flops"])
    n_dev = 1
    for v in sizes.values():
        n_dev *= v
    report = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "kind": shape.kind, "devices": n_dev,
        "lower_s": round(full["seconds"], 1), "compile_s": None,
        "flops_per_device": full["flops"],
        "bytes_accessed_per_device": None,
        "flops_per_device_raw": full["flops"],
        "per_unit_flops": per_unit,
        "memory": {
            "argument_bytes": full["argument_bytes"],
            "output_bytes": full["output_bytes"],
            "temp_bytes": full["temp_bytes"],
            "alias_bytes": full["alias_bytes"],
            "code_bytes": None,
        },
        "null_reasons": NULL_REASONS,
        "collectives": {
            "count": len(full["colls"]),
            "per_chip_link_bytes": full["link_bytes"],
            "per_chip_link_bytes_raw": full["link_bytes"],
            "by_kind": _by_kind(full["colls"]),
        },
        # views DTensor's own rule refused, redistributed instead (each
        # distinct shape once; their collectives are in "collectives")
        "view_fallbacks": full["view_fallbacks"],
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "tokens": (shape.global_batch * shape.seq_len
                   if shape.kind != "decode" else shape.global_batch),
        "hbm_bytes": hw["hbm_bytes"],
    }
    if tag:
        report["tag"] = tag
    return report


def per_device_bytes(rep: dict) -> int:
    m = rep["memory"]
    return (m["argument_bytes"] + m["temp_bytes"] + m["output_bytes"]
            - m["alias_bytes"])


def save_report(rep: dict):
    os.makedirs(REPORT_DIR, exist_ok=True)
    name = f"{rep['arch']}__{rep['shape']}__{rep.get('mesh', 'skip')}.json"
    with open(os.path.join(REPORT_DIR, name), "w") as f:
        json.dump(rep, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--and-multi-pod", action="store_true",
                    help="run each cell on both meshes")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(all_configs())
    shapes = [args.shape] if args.shape else list(SHAPES)
    cells = [(a, s) for a in archs for s in shapes]
    meshes = [args.multi_pod] if not args.and_multi_pod else [False, True]
    failures = 0
    t_all = time.time()
    for mp in meshes:   # one fake group per mesh size
        for a, s in cells:
            tag = f"{a} x {s} [{'2x16x16' if mp else '16x16'}]"
            try:
                rep = lower_cell(a, s, multi_pod=mp)
                if rep["status"] == "skipped":
                    if not mp or not args.and_multi_pod:
                        save_report(rep)
                        print(f"SKIP {tag}: {rep['why']}")
                    continue
                save_report(rep)
                gib = per_device_bytes(rep) / 2**30
                print(f"OK   {tag}: run={rep['lower_s']}s "
                      f"flops/dev={rep['flops_per_device']:.3e} "
                      f"mem/dev={gib:.2f}GiB of "
                      f"{rep['hbm_bytes'] / 2**30:.0f} "
                      f"link/dev={rep['collectives']['per_chip_link_bytes']:.3e}B "
                      f"coll={rep['collectives']['count']} "
                      f"view_fallbacks={rep['view_fallbacks']}", flush=True)
            except Exception as e:  # noqa: BLE001 -- report and continue
                failures += 1
                print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
    print(f"dry-run took {time.time() - t_all:.1f} s")
    if failures:
        raise SystemExit(f"{failures} cells failed")
    print("dry-run complete")


if __name__ == "__main__":
    main()
