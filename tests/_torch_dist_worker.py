"""The port's side of tests/test_torch_distributed.py: four gloo ranks on
the CPU, spawned by ``torch.multiprocessing`` with a ``file://`` store.

    python tests/_torch_dist_worker.py <dir>

``<dir>`` holds ``cases.pkl`` (the reduced configs' names and widths,
the carried weights in the JAX package's layout, the batches and the
compression inputs), written by the test.  Rank 0 writes ``torch.pkl``:
per case the mesh-less and the sharded results, and the local shapes
that reached kernels G and H.  Imports torch and repro_torch only.
"""
import dataclasses
import os
import pickle
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4


def _cfg(arch, widths):
    from repro_torch.configs import get_config, reduced

    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    return dataclasses.replace(cfg, **widths)


def _lm(cfg, tree):
    from repro_torch.core import interop

    return interop.lm_params_from_numpy(cfg, tree, device="cpu")


def _full(tree):
    """Parameters (plain or DTensor) as whole plain tensors."""
    from repro_torch.core.tree import tree_map

    return tree_map(lambda t: (t.full_tensor() if hasattr(t, "full_tensor")
                               else t).detach(), tree)


def _comms(fn):
    """``fn()``'s result, the collectives DTensor issued on this rank
    (CommDebugMode's counts by op name) and the views DTensor's own rule
    refused that were redistributed."""
    import repro_torch.distributed.sharding as dsh
    from repro_torch.launch.dryrun import comm_counter

    before = dsh.view_fallbacks
    with comm_counter() as comm:
        out = fn()
    counts = {str(k).split(".")[-1]: v
              for k, v in comm.get_comm_counts().items() if v}
    return out, {"counts": counts,
                 "view_fallbacks": dsh.view_fallbacks - before}


def _recorder(shapes):
    """Record the local shapes that reach G's and H's custom ops."""
    import repro_torch.kernels.flash_attn.ops as g_ops
    import repro_torch.kernels.ssd.ops as h_ops

    for name, mod in (("G", g_ops), ("H", h_ops)):
        fwd = mod._forward

        def rec(*a, _fwd=fwd, _name=name):
            assert not hasattr(a[0], "device_mesh"), "a DTensor reached it"
            shapes.append((_name, tuple(a[0].shape)))
            return _fwd(*a)
        mod._forward = rec


def train_case(case, mesh, shapes):
    from repro_torch.core import interop
    from repro_torch.core.tree import param_tree
    from repro_torch.distributed import TRAIN_RULES
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import make_train_step

    cfg = _cfg(case["arch"], case["widths"])
    opt = AdamWConfig(**case["opt"])
    out = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        lm = _lm(cfg, case["params"])
        state = adamw_init(lm, opt)
        step = make_train_step(cfg, m, TRAIN_RULES if m else None, opt,
                               accum_steps=case["accum"])
        shapes.clear()

        def run(lm=lm, state=state, step=step):
            metrics = []
            for b in case["batches"]:
                lm, state, met = step(lm, state, {k: torch.from_numpy(v)
                                                  for k, v in b.items()})
                metrics.append({k: float(v) for k, v in met.items()})
            return lm, metrics
        (lm, metrics), comms = _comms(run)
        out[name] = {"metrics": metrics,
                     "params": interop.stack_units(_full(param_tree(lm))),
                     "shapes": list(shapes), "comms": comms}
    return out


def serve_case(case, mesh, shapes):
    from repro_torch.distributed import SERVE_RULES
    from repro_torch.serve.engine import (grow_cache, make_decode_step,
                                          make_prefill_step)

    cfg = _cfg(case["arch"], case["widths"])
    prompts = torch.from_numpy(case["prompts"])
    plen, new = prompts.shape[1], case["new"]
    out = {}
    for name, m, r in (("plain", None, None), ("mesh", mesh, SERVE_RULES)):
        lm = _lm(cfg, case["params"])
        full = (lambda t: t.full_tensor()) if m is not None else \
            (lambda t: t)
        shapes.clear()

        def run(lm=lm, m=m, r=r, full=full):
            logits, cache = make_prefill_step(cfg, m, r)(
                lm, {"tokens": prompts})
            cache = grow_cache(cache, plen + new, m, r)
            seen = [full(logits)]
            tok = torch.argmax(seen[0], -1).to(torch.int32)[:, None]
            step = make_decode_step(cfg, m, r)
            for n in range(plen, plen + new - 1):
                tok, logits, cache = step(lm, cache, tok, n)
                tok = full(tok)
                seen.append(full(logits))
            return seen, cache
        (seen, cache), comms = _comms(run)
        blk = next(b for u in cache["unit"] for b in u.values() if "k" in b)
        out[name] = {"logits": torch.stack(seen, 1).numpy(),
                     "shapes": list(shapes), "comms": comms,
                     "k_placements": (str(blk["k"].placements) if m
                                       else None)}
    return out


def compress_case(case, mesh3):
    from repro_torch.train.compress import ef_int8_psum

    pod = mesh3.get_local_rank("pod")
    rows = case["grads"]["a"].shape[0] // mesh3.size(0)
    local = {k: torch.from_numpy(v[pod * rows:(pod + 1) * rows])
             for k, v in case["grads"].items()}
    res = {k: torch.from_numpy(v[pod * rows:(pod + 1) * rows])
           for k, v in case["residual"].items()}
    summed, new_res = ef_int8_psum(local, res, "pod", mesh=mesh3)
    return {"summed": {k: v.numpy() for k, v in summed.items()},
            "residual": {k: v.numpy() for k, v in new_res.items()}}


def restore_case(case, mesh, ckpt_dir):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.store import save_checkpoint
    from repro_torch.core.tree import param_tree, tree_leaves
    from repro_torch.distributed import TRAIN_RULES
    from repro_torch.models import transformer as tfm
    from repro_torch.models.params import shardings

    cfg = _cfg(case["arch"], case["widths"])
    lm = _lm(cfg, case["params"])
    if dist.get_rank() == 0:
        save_checkpoint(ckpt_dir, 3, param_tree(lm))
    dist.barrier()
    like = param_tree(tfm.init_params(cfg, torch.Generator().manual_seed(9),
                                      device="cpu"))
    sh = shardings(tfm.lm_specs(cfg), mesh, TRAIN_RULES)
    got, step = CheckpointManager(ckpt_dir).restore_latest(
        like, shardings_tree=sh)
    pairs = list(zip(tree_leaves(param_tree(lm)), tree_leaves(got)))
    local = [tuple(b.to_local().shape) for _, b in pairs]
    return {"step": step, "leaves": len(pairs),
            "all_dtensor": all(hasattr(b, "device_mesh") for _, b in pairs),
            "equal": all(torch.equal(a, b.full_tensor()) for a, b in pairs),
            "sharded": sum(s != tuple(a.shape)
                           for s, (a, _) in zip(local, pairs))}


def run(rank: int, work: str, init_file: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=WORLD)
    try:
        from repro_torch.launch.mesh import make_mesh_compat

        with open(os.path.join(work, "cases.pkl"), "rb") as f:
            cases = pickle.load(f)
        m22 = make_mesh_compat((2, 2), ("data", "model"), "cpu")
        m14 = make_mesh_compat((1, 4), ("data", "model"), "cpu")
        m212 = make_mesh_compat((2, 1, 2), ("pod", "data", "model"), "cpu")
        shapes: list = []
        _recorder(shapes)
        out = {}
        for name, case in cases["train"].items():
            out[f"train/{name}"] = train_case(case, m22, shapes)
        for name, case in cases["serve"].items():
            out[f"serve/{name}"] = serve_case(case, m14, shapes)
        out["compress"] = compress_case(cases["compress"], m212)
        out["restore"] = restore_case(cases["restore"], m22,
                                      os.path.join(work, "ckpt"))
        gathered = [None] * WORLD if rank == 0 else None
        dist.gather_object(out["compress"], gathered, dst=0)
        if rank == 0:
            out["compress_by_rank"] = gathered
            with open(os.path.join(work, "torch.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    work = sys.argv[1]
    init_file = os.path.join(tempfile.mkdtemp(dir=work), "store")
    mp.spawn(run, args=(work, init_file), nprocs=WORLD)
