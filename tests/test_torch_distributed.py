"""The port's mesh against the JAX package's, on the CPU.

Four gloo ranks (``tests/_torch_dist_worker.py``, spawned in a process
of its own with a ``file://`` store) and the JAX package on four forced
host devices (a subprocess, as tests/test_multidevice.py runs it) take
the same carried weights and batches, in parallel:

* train: reduced qwen3 at tests/test_multidevice.py's widths and reduced
  zamba2, float32, on a (2, 2) ("data", "model") mesh under TRAIN_RULES,
  two steps: loss, metrics and every updated leaf against
  ``jax.jit(make_train_step(cfg, mesh, TRAIN_RULES, opt))`` and against
  the port's mesh-less step (1e-5 for the loss, 1e-4 for leaves, as
  tests/test_torch_train.py holds them), granite ``moe_impl="sorted"``
  too;
* serve: prefill and greedy decode under SERVE_RULES on (1, 4) against
  the JAX package's jitted ``make_prefill_step`` / ``make_decode_step``
  on the same mesh and against the mesh-less path, within
  tests/test_torch_lm.py's float32 limit: qwen3 and zamba2 split their
  caches' kv heads, and qwen3 with 2 kv heads, which the model axis does
  not divide, splits its caches' sequence (``cache_seq``);
* the collectives DTensor issued (CommDebugMode) and the views it
  redistributed, case by case;
* the local shapes that reached kernels G and H (batch and heads split);
* ``ef_int8_psum`` on a (2, 1, 2) ("pod", "data", "model") mesh against
  the JAX package's under ``shard_map``, bit for bit (a sum of two ranks
  is one rounding in both);
* an elastic restore of a mesh-less checkpoint onto (2, 2).
Nothing is left in the pytest process: no process group, no device."""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
from _torch_train_cases import batch_np, worst_leaves
from repro_torch.core import interop
from repro_torch.models import transformer as ttfm

ROOT = Path(__file__).resolve().parent.parent
LOSS_REL = 1e-5     # tests/test_torch_train.py
LEAF_REL = 1e-4     # RMS(diff) / RMS(reference) per updated leaf
LOGITS_REL = 1e-4   # tests/test_torch_lm.py, float32
QWEN_WIDTHS = {"d_model": 64, "num_heads": 8, "num_kv_heads": 4,
               "head_dim": 16, "d_ff": 128}   # tests/test_multidevice.py
OPT = {"lr": 1e-3, "warmup_steps": 2, "total_steps": 10}
TRAIN = {"qwen3": ("qwen3_8b", QWEN_WIDTHS),
         "zamba2": ("zamba2_1_2b", {}),
         "granite_sorted": ("granite_moe_3b", {"moe_impl": "sorted"})}
# name: (arch, widths, the cache dim the (1, 4) mesh splits)
SERVE = {"qwen3": ("qwen3_8b", QWEN_WIDTHS, 2),
         "zamba2": ("zamba2_1_2b", {}, 2),
         "qwen3_cache_seq": ("qwen3_8b", {**QWEN_WIDTHS, "num_kv_heads": 2},
                             1)}
STEPS = 2

JAX_SIDE = r"""
import os, sys, pickle, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import get_config, reduced
from repro.distributed.sharding import SERVE_RULES, TRAIN_RULES
from repro.launch.mesh import make_mesh_compat
from repro.optim.adamw import AdamWConfig, adamw_init
from repro.serve.engine import make_decode_step, make_prefill_step
from repro.train import step as jstep
from repro.train.compress import ef_int8_psum
work = sys.argv[1]
cases = pickle.load(open(os.path.join(work, "cases.pkl"), "rb"))
out = {}
mesh = make_mesh_compat((2, 2), ("data", "model"))
for name, case in cases["train"].items():
    cfg = dataclasses.replace(reduced(get_config(case["arch"])),
                              dtype="float32", **case["widths"])
    opt = AdamWConfig(**case["opt"])
    p = jax.tree.map(jnp.asarray, case["params"])
    s = adamw_init(p, opt)
    fn = jax.jit(jstep.make_train_step(cfg, mesh, TRAIN_RULES, opt,
                                       accum_steps=case["accum"]))
    metrics = []
    with mesh:
        for b in case["batches"]:
            p, s, m = fn(p, s, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
    out["train/" + name] = {"metrics": metrics, "params": jax.tree.map(
        lambda x: np.asarray(x, np.float32), p)}
mesh14 = make_mesh_compat((1, 4), ("data", "model"))


def grow(path, x, s_max):
    # ServeEngine.generate's growth of the k / v caches
    if any(str(getattr(q, "key", "")) in ("k", "v") for q in path):
        pad = [(0, 0)] * x.ndim
        pad[x.ndim - 3] = (0, s_max - x.shape[x.ndim - 3])
        return jnp.pad(x, pad)
    return x


for name, case in cases["serve"].items():
    cfg = dataclasses.replace(reduced(get_config(case["arch"])),
                              dtype="float32", **case["widths"])
    p = jax.tree.map(jnp.asarray, case["params"])
    prompts = jnp.asarray(case["prompts"])
    plen, new = prompts.shape[1], case["new"]
    prefill = jax.jit(make_prefill_step(cfg, mesh14, SERVE_RULES))
    decode = jax.jit(make_decode_step(cfg, mesh14, SERVE_RULES))
    with mesh14:
        logits, cache = prefill(p, {"tokens": prompts})
        cache = jax.tree_util.tree_map_with_path(
            lambda q, x: grow(q, x, plen + new), cache)
        seen = [logits]
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        for n in range(plen, plen + new - 1):
            tok, logits, cache = decode(p, cache, tok, jnp.int32(n))
            seen.append(logits)
    out["serve/" + name] = {"logits": np.stack(
        [np.asarray(x, np.float32) for x in seen], 1)}
mesh3 = make_mesh_compat((2, 1, 2), ("pod", "data", "model"))
shard_map = getattr(jax, "shard_map", None)
if shard_map is None:
    from jax.experimental.shard_map import shard_map
c = cases["compress"]
f = shard_map(lambda g, r: ef_int8_psum(g, r, "pod"), mesh=mesh3,
              in_specs=(P("pod"), P("pod")), out_specs=(P(), P("pod")))
summed, res = jax.jit(f)(jax.tree.map(jnp.asarray, c["grads"]),
                         jax.tree.map(jnp.asarray, c["residual"]))
out["compress"] = {"summed": jax.tree.map(np.asarray, summed),
                   "residual": jax.tree.map(np.asarray, res)}
pickle.dump(out, open(os.path.join(work, "jax.pkl"), "wb"))
"""


def _cfg(arch, widths):
    return dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)),
                               dtype="float32", **widths)


def _weights(cfg, seed):
    """The port's init in the JAX package's layout (NumPy float32)."""
    lm = ttfm.init_params(cfg, torch.Generator().manual_seed(seed),
                          device="cpu")
    return interop.lm_params_to_numpy(cfg, lm)


def _cases():
    train = {}
    for i, (name, (arch, widths)) in enumerate(TRAIN.items()):
        cfg = _cfg(arch, widths)
        train[name] = {"arch": arch, "widths": widths, "opt": OPT, "accum": 1,
                       "params": _weights(cfg, 13 + i),
                       "batches": [batch_np(cfg, 4, 32, step=s)
                                   for s in range(STEPS)]}
    serve = {}
    for i, (name, (arch, widths, _)) in enumerate(SERVE.items()):
        cfg = _cfg(arch, widths)
        rng = np.random.default_rng(7 + i)
        serve[name] = {"arch": arch, "widths": widths,
                       "params": _weights(cfg, 23 + i), "new": 4,
                       "prompts": rng.integers(0, cfg.vocab_size, (4, 16),
                                               dtype=np.int32)}
    rng = np.random.default_rng(5)
    grads = {"a": (rng.standard_normal((4, 64)) * 0.01).astype(np.float32),
             "b": (rng.standard_normal((4, 16)) * 3.0).astype(np.float32)}
    residual = {k: (rng.standard_normal(v.shape) * 1e-4).astype(np.float32)
                for k, v in grads.items()}
    restore = {"arch": "zamba2_1_2b", "widths": {},
               "params": serve["zamba2"]["params"]}
    return {"train": train, "serve": serve, "restore": restore,
            "compress": {"grads": grads, "residual": residual}}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh")
    cases = _cases()
    with open(work / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = {"PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                          str(ROOT / "tests")]),
           "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", str(work)),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", JAX_SIDE, str(work)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True),
             subprocess.Popen([sys.executable,
                               str(ROOT / "tests" / "_torch_dist_worker.py"),
                               str(work)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)]
    for p in procs:
        _, err = p.communicate(timeout=900)
        assert p.returncode == 0, err[-4000:]
    with open(work / "jax.pkl", "rb") as f:
        jax_out = pickle.load(f)
    with open(work / "torch.pkl", "rb") as f:
        torch_out = pickle.load(f)
    return cases, jax_out, torch_out


def _metrics_close(got, want, what):
    for step, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "aux_loss", "tokens", "lr", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_REL, atol=1e-7,
                                       err_msg=(what, step, k))


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_sharded_train_step_matches_jax_sharded_step(results, name):
    _, jax_out, torch_out = results
    got, want = torch_out[f"train/{name}"]["mesh"], jax_out[f"train/{name}"]
    _metrics_close(got["metrics"], want["metrics"], name)
    worst = worst_leaves(got["params"], want["params"])
    assert worst[0][1] < LEAF_REL, worst


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_sharded_train_step_matches_meshless_step(results, name):
    _, _, torch_out = results
    r = torch_out[f"train/{name}"]
    _metrics_close(r["mesh"]["metrics"], r["plain"]["metrics"], name)
    worst = worst_leaves(r["mesh"]["params"], r["plain"]["params"])
    assert worst[0][1] < LEAF_REL, worst


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_train_kernels_see_local_shards(results, name):
    """On (2, 2) each rank's G gets half the batch and half the heads, and
    H (zamba2) half the batch and half the SSM heads."""
    cases, _, torch_out = results
    case = cases["train"][name]
    cfg = _cfg(case["arch"], case["widths"])
    r = torch_out[f"train/{name}"]
    for kernel, heads_dim, heads in (
            ("G", 2, cfg.num_heads),
            ("H", 3, cfg.ssm and cfg.ssm.expand * cfg.d_model
             // cfg.ssm.head_dim)):
        plain = [s for k, s in r["plain"]["shapes"] if k == kernel]
        local = [s for k, s in r["mesh"]["shapes"] if k == kernel]
        assert len(plain) == len(local), kernel
        for p, m in zip(plain, local):
            assert m[0] * 2 == p[0] and m[heads_dim] * 2 == p[heads_dim] \
                == heads, (kernel, p, m)
    assert any(k == "G" for k, _ in r["mesh"]["shapes"])


def _logits_err(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("name", sorted(SERVE))
def test_sharded_serving_matches_jax_sharded_serving(results, name):
    _, jax_out, torch_out = results
    err = _logits_err(torch_out[f"serve/{name}"]["mesh"]["logits"],
                      jax_out[f"serve/{name}"]["logits"])
    assert err <= LOGITS_REL, err


@pytest.mark.parametrize("name", sorted(SERVE))
def test_sharded_serving_matches_meshless(results, name):
    _, _, torch_out = results
    r = torch_out[f"serve/{name}"]
    err = _logits_err(r["mesh"]["logits"], r["plain"]["logits"])
    assert err <= LOGITS_REL, err


@pytest.mark.parametrize("name", sorted(SERVE))
def test_serving_kernels_see_local_heads(results, name):
    """SERVE_RULES on (1, 4): G and H each get a quarter of the heads.
    The caches split their kv heads where 4 divides them (qwen3's 4,
    zamba2's) and their sequence where it does not (2 kv heads)."""
    _, _, torch_out = results
    r = torch_out[f"serve/{name}"]
    pairs = list(zip(r["plain"]["shapes"], r["mesh"]["shapes"]))
    assert pairs
    for (k, p), (k2, m) in pairs:
        dim = 2 if k == "G" else 3
        assert k == k2 and m[dim] * 4 == p[dim] and m[0] == p[0], (p, m)
    want = f"Shard(dim={SERVE[name][2]})"
    assert want in r["mesh"]["k_placements"], r["mesh"]["k_placements"]


# The collectives rank 0 issued over the case (CommDebugMode, torch
# 2.13 on the CPU): a change of sharding rules, of ``shard`` sites or of
# torch moves them, and then this table, on purpose.
COLLECTIVES = {
    "train/qwen3": {"all_gather_into_tensor": 136,
                    "reduce_scatter_tensor": 100, "all_reduce": 152},
    "train/zamba2": {"all_gather_into_tensor": 948,
                     "reduce_scatter_tensor": 624, "all_reduce": 898},
    "train/granite_sorted": {"all_gather_into_tensor": 182,
                             "reduce_scatter_tensor": 102,
                             "all_reduce": 114},
    "serve/qwen3": {"all_gather_into_tensor": 17,
                    "reduce_scatter_tensor": 2, "all_reduce": 6},
    "serve/zamba2": {"all_gather_into_tensor": 24,
                     "reduce_scatter_tensor": 9, "all_reduce": 55},
    "serve/qwen3_cache_seq": {"all_gather_into_tensor": 23,
                              "reduce_scatter_tensor": 5, "all_reduce": 6},
}


@pytest.mark.parametrize("case", sorted(COLLECTIVES))
def test_collectives_are_the_counted_ones(results, case):
    """The mesh-less path issues none; the mesh path exactly the table's,
    and no view was redistributed behind DTensor's own rules."""
    r = results[2][case]
    assert r["plain"]["comms"] == {"counts": {}, "view_fallbacks": 0}
    assert r["mesh"]["comms"]["counts"] == COLLECTIVES[case]
    assert r["mesh"]["comms"]["view_fallbacks"] == 0


def test_ef_int8_psum_matches_shard_map(results):
    _, jax_out, torch_out = results
    want = jax_out["compress"]
    rows = want["residual"]["a"].shape[0] // 2
    for rank, got in enumerate(torch_out["compress_by_rank"]):
        pod = rank // 2             # mesh (2, 1, 2): rank = 2 * pod + model
        for k in want["summed"]:
            np.testing.assert_array_equal(got["summed"][k],
                                          want["summed"][k])
            np.testing.assert_array_equal(
                got["residual"][k],
                want["residual"][k][pod * rows:(pod + 1) * rows])


def test_elastic_restore_onto_a_2x2_mesh(results):
    r = results[2]["restore"]
    assert r["step"] == 3 and r["leaves"] > 50
    assert r["all_dtensor"] and r["equal"] and r["sharded"] > 0, r


def test_nothing_left_in_this_process():
    import torch.distributed as dist

    assert not dist.is_initialized()
