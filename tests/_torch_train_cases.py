"""Shared helpers of the port's training tests (tests/test_torch_train*.py):
reduced configs in both packages, carried weights, SyntheticLM batches,
both packages' loss gradients in the JAX package's stacked layout, and
the per-leaf RMS(diff) / RMS(reference) measure."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
from repro.configs import get_config, reduced
from repro.distributed.sharding import TRAIN_RULES, shard_ctx
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as jtfm
from repro.train import step as jstep
from repro_torch.core import interop
from repro_torch.core.tree import param_tree, tree_map
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.train import step as tstep

F32 = 1e-5          # kernel gradients, relative, float32
LOSS_REL = 1e-5     # loss, relative, float32
LEAF_REL = 1e-4     # RMS(diff) / RMS(grad) per leaf, float32
BF16_REL = 2e-2     # the loss in bfloat16 (reduced Zamba2)
SHAPE = (2, 32)     # (batch, seq) of the loss checks


def cfgs(arch, dtype="float32", **kw):
    """The reduced config in both packages, in ``dtype``."""
    j = dataclasses.replace(reduced(get_config(arch)), dtype=dtype, **kw)
    t = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)),
                            dtype=dtype, **kw)
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel_rms(got, want):
    got, want = _np(got), _np(want)
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / max(np.sqrt(np.mean(want ** 2)), 1e-30))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def worst_leaves(got: dict, want: dict, n: int = 3):
    """The ``n`` leaves of largest RMS(diff) / RMS(want), largest first."""
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w), set(g) ^ set(w)
    errs = {k: _rel_rms(g[k], w[k]) for k in w}
    return sorted(errs.items(), key=lambda kv: -kv[1])[:n]


def batch_np(cfg, b, s, step=0):
    """A SyntheticLM batch as NumPy (and stub frames for whisper)."""
    out = SyntheticLM(cfg.vocab_size, s, b).batch(step)
    if cfg.encoder:
        rng = np.random.default_rng(100 + step)
        out["enc_frames"] = (rng.standard_normal(
            (b, cfg.encoder.num_frames, cfg.d_model)) * 0.02).astype(
                np.float32)
    return out


def jbatch(b, dtype):
    return {k: (jnp.asarray(v, dtype) if k == "enc_frames" else
                jnp.asarray(v)) for k, v in b.items()}


def tbatch(b, dtype):
    return {k: (torch.from_numpy(v).to(dtype) if k == "enc_frames" else
                torch.from_numpy(v)) for k, v in b.items()}


def carried(jcfg, tcfg, seed):
    """JAX weights from ``seed`` and the port's ``LM`` holding them."""
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(seed))
    jp = jax.tree.map(lambda x: x.astype(jnp.dtype(jcfg.dtype)), jp)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    return jp, interop.lm_params_from_numpy(tcfg, tree, device="cpu")


def port_grads(lm, tcfg, batch):
    """(loss, metrics, JAX-layout gradient tree) of the port's loss_fn."""
    lm.requires_grad_(True)
    lm.zero_grad(set_to_none=True)
    total, metrics = tstep.loss_fn(lm, tcfg, batch)
    total.backward()
    grads = tree_map(lambda p: p.grad if p.grad is not None
                     else torch.zeros_like(p), param_tree(lm))
    return total, metrics, interop.stack_units(grads)


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh()


def jax_grads(jp, jcfg, batch, mesh):
    def f(p, b):
        with shard_ctx(mesh, TRAIN_RULES):
            return jax.value_and_grad(jstep.loss_fn, has_aux=True)(p, jcfg,
                                                                   b)
    (total, metrics), g = jax.jit(f)(jp, batch)
    return total, metrics, jax.tree.map(lambda x: np.asarray(x, np.float32),
                                        g)


