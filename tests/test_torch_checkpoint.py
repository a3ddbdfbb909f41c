"""The port's checkpoints against the JAX package's on the CPU:
tests/test_checkpoint.py's roundtrip, LATEST / prune, torn write,
restore-latest and train-resume tests on the port; a plain tree with
bfloat16 and int leaves crossing both ways bit for bit, in the same
layout; a reduced Zamba2 checkpoint written by the JAX package giving the
port the same loss; and ``launch/train.py`` resuming from its own
checkpoint."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import repro.checkpoint as jckpt
import repro_torch.configs as tconfigs
from repro.configs import get_config, reduced
from repro.models import transformer as jtfm
from repro.train import step as jstep
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import ShapeSpec
from repro_torch.core import interop
from repro_torch.core.tree import param_tree, tree_leaves, tree_map
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as ttfm
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train import step as tstep


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": {"a": torch.randn(16, 8, generator=g),
                  "b": torch.arange(10, dtype=torch.int32),
                  "h": torch.randn(3, 5, generator=g).bfloat16()},
            "layers": [torch.ones(2), torch.zeros(4, dtype=torch.int32)],
            "step": torch.tensor(7, dtype=torch.int32)}


def _zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 5, t)
    _same(t, restore_checkpoint(str(tmp_path), 5, _zeros_like(t),
                                device="cpu"))


def test_latest_pointer_and_prune(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, save_every=1)
    for s in (1, 2, 3, 4):
        assert mgr.maybe_save(s, _tree(s))
    assert latest_step(str(tmp_path)) == 4
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000003", "step_00000004"]
    os.remove(tmp_path / "LATEST")          # lost pointer: scan instead
    assert latest_step(str(tmp_path)) == 4


def test_crash_mid_write_ignored(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    os.makedirs(tmp_path / "step_00000002.tmp")  # simulated torn write
    assert latest_step(str(tmp_path)) == 1


def test_restore_latest_resumes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_every=1)
    t = _tree(3)
    mgr.maybe_save(3, t)
    restored, step = mgr.restore_latest(_zeros_like(t), device="cpu")
    assert step == 3
    _same(t, restored)
    assert CheckpointManager(str(tmp_path / "none")).restore_latest(t) \
        == (None, 0)


def test_restore_fills_tensor_leaves_in_place(tmp_path):
    """Restoring into a tree of tensors (an LM's ``param_tree``) fills
    those tensors, so the LM holds the checkpoint with no second copy of
    its weights; a stored shape that differs from the tree's raises."""
    cfg = tconfigs.reduced(tconfigs.get_config("zamba2_1_2b"))
    src = ttfm.init_params(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    save_checkpoint(str(tmp_path), 1, {"params": param_tree(src)})
    lm = ttfm.init_params(cfg, torch.Generator().manual_seed(2),
                          device="cpu")
    leaves = tree_leaves(param_tree(lm))
    ptrs = [p.data_ptr() for p in leaves]
    r = restore_checkpoint(str(tmp_path), 1, {"params": param_tree(lm)})
    assert all(a is b for a, b in zip(tree_leaves(r["params"]), leaves))
    assert [p.data_ptr() for p in leaves] == ptrs
    _same(param_tree(src), param_tree(lm))
    save_checkpoint(str(tmp_path), 2, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), 2, {"a": torch.zeros(4)})


def _jax_tree(seed=0):
    k = jax.random.PRNGKey(seed)
    return {"w": {"a": jax.random.normal(k, (16, 8)),
                  "b": jnp.arange(10, dtype=jnp.int32),
                  "h": jax.random.normal(k, (3, 5)).astype(jnp.bfloat16)},
            "step": jnp.int32(7)}


def test_jax_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    t = _jax_tree()
    jckpt.save_checkpoint(str(tmp_path), 2, t)
    like = {"w": {"a": torch.zeros(16, 8),
                  "b": torch.zeros(10, dtype=torch.int32),
                  "h": torch.zeros(3, 5, dtype=torch.bfloat16)},
            "step": torch.tensor(0, dtype=torch.int32)}
    r = restore_checkpoint(str(tmp_path), 2, like, device="cpu")
    assert r["w"]["h"].dtype == torch.bfloat16
    for a, b in zip(jax.tree.leaves(t), tree_leaves(r)):
        assert_array_equal(b.float().numpy(), np.asarray(a, np.float32))


def test_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path):
    """And both packages write the same files, keys and meta.json."""
    t = _tree(1)
    del t["layers"]
    save_checkpoint(str(tmp_path / "port"), 4, t)
    like = {"w": {"a": jnp.zeros((16, 8)), "b": jnp.zeros(10, jnp.int32),
                  "h": jnp.zeros((3, 5), jnp.bfloat16)},
            "step": jnp.int32(0)}
    r = jckpt.restore_checkpoint(str(tmp_path / "port"), 4, like)
    assert r["w"]["h"].dtype == jnp.bfloat16
    for a, b in zip(tree_leaves(t), jax.tree.leaves(r)):
        assert_array_equal(np.asarray(b, np.float32), a.float().numpy())
    jckpt.save_checkpoint(str(tmp_path / "jax"), 4, r)
    for d in ("port", "jax"):
        assert sorted(os.listdir(tmp_path / d)) == ["LATEST",
                                                    "step_00000004"]
        assert (tmp_path / d / "LATEST").read_text() == "step_00000004"
    step_dirs = [tmp_path / d / "step_00000004" for d in ("port", "jax")]
    assert sorted(os.listdir(step_dirs[0])) == sorted(
        os.listdir(step_dirs[1])) == ["meta.json", "shard_0.npz"]
    metas = [json.loads((d / "meta.json").read_text()) for d in step_dirs]
    assert metas[0] == metas[1]
    with np.load(step_dirs[0] / "shard_0.npz") as a, \
            np.load(step_dirs[1] / "shard_0.npz") as b:
        assert sorted(a.files) == sorted(b.files) == [
            "step", "w__a", "w__b", "w__h"]
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            assert_array_equal(a[k], b[k])


def test_jax_zamba2_checkpoint_gives_the_port_the_same_loss(tmp_path):
    import dataclasses

    jcfg = dataclasses.replace(reduced(get_config("zamba2_1_2b")),
                               dtype="float32")
    tcfg = dataclasses.replace(
        tconfigs.reduced(tconfigs.get_config("zamba2_1_2b")),
        dtype="float32")
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(21))
    jckpt.save_checkpoint(str(tmp_path), 1, {"params": jp})
    like = {"params": interop.lm_params_to_numpy(
        tcfg, ttfm.init_params(tcfg, torch.Generator().manual_seed(0),
                               device="cpu"))}
    r = restore_checkpoint(str(tmp_path), 1, like, device="cpu")
    lm = interop.lm_params_from_numpy(
        tcfg, tree_map(lambda t: t.numpy(), r["params"]), device="cpu")
    batch = make_batch(tcfg, ShapeSpec("t", 32, 2, "train"), device="cpu")
    want, _ = jstep.loss_fn(jp, jcfg, {k: jnp.asarray(v.numpy())
                                       for k, v in batch.items()})
    with torch.no_grad():
        got, _ = tstep.loss_fn(lm, tcfg, batch)
    assert_allclose(float(got), float(want), rtol=1e-5)


def test_train_resume_equivalence(tmp_path):
    """Training 2 steps == training 1, checkpointing, restoring, 1 more
    (bit for bit on the CPU)."""
    cfg = tconfigs.reduced(tconfigs.get_config("phi3_mini_3_8b"))
    shape = ShapeSpec("t", 32, 2, "train")
    opt = AdamWConfig(lr=1e-3)
    step = tstep.make_train_step(cfg, None, None, opt)

    def fresh():
        lm = ttfm.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
        return lm, adamw_init(lm, opt)

    pa, sa = fresh()
    for i in range(2):
        pa, sa, _ = step(pa, sa, make_batch(cfg, shape, i, device="cpu"))

    pb, sb = fresh()
    pb, sb, _ = step(pb, sb, make_batch(cfg, shape, 0, device="cpu"))
    save_checkpoint(str(tmp_path), 1, {"params": param_tree(pb),
                                       "opt": sb})
    pc, sc = fresh()
    restore_checkpoint(str(tmp_path), 1, {"params": param_tree(pc),
                                          "opt": sc}, device="cpu")
    pc, sc, _ = step(pc, sc, make_batch(cfg, shape, 1, device="cpu"))
    _same(param_tree(pa), param_tree(pc))
    _same(sa, sc)


def test_launch_train_resumes_from_its_own_checkpoint(tmp_path):
    """A run of 6 steps checkpoints at step 4; a second run with the same
    flags resumes there and ends on the first run's loss, bit for bit."""
    argv = ["--arch", "zamba2_1_2b", "--smoke", "--device", "cpu",
            "--steps", "6", "--seq-len", "32", "--batch", "2",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "4",
            "--log-every", "1"]
    first = tlaunch.main(argv)
    assert first["start"] == 0 and latest_step(str(tmp_path)) == 4
    second = tlaunch.main(argv)
    assert second["start"] == 4
    for k in ("loss", "grad_norm", "lr"):
        assert second[k] == first[k], k
