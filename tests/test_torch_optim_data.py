"""The port's optimizer, gradient compression and data pipeline against
the JAX package on the CPU: ``adamw_update`` on the same NumPy
parameters, gradients and state (float32 and bfloat16 moments, clipping
on and off, both ends of the schedule), ``global_norm``,
``cosine_schedule``, the int8 codes of ``_quant_int8`` and
``ef_int8_allreduce_sim``, and ``SyntheticLM`` / ``make_batch``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import repro_torch.configs as tconfigs
from repro.configs import ShapeSpec, get_config, reduced
from repro.data import pipeline as jdata
from repro.optim import adamw as jadamw
from repro.train import compress as jcompress
from repro_torch.core.tree import tree_leaves
from repro_torch.data import pipeline as tdata
from repro_torch.optim import adamw as tadamw
from repro_torch.train import compress as tcompress

F32 = 1e-6      # float32 arithmetic in the same order: a few ulps


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tree(rng, scale=1.0):
    """(NumPy float32 arrays, the dtype each leaf is held in)."""
    arrays = {"w": rng.standard_normal((8, 16)) * scale,
              "blk": {"norm": rng.standard_normal(16) * scale,
                      "emb": rng.standard_normal((5, 4)) * scale}}
    dtypes = {"w": "bfloat16", "blk": {"norm": "float32",
                                       "emb": "bfloat16"}}
    return arrays, dtypes


def _as(arrays, dtypes, make):
    if isinstance(arrays, dict):
        return {k: _as(arrays[k], dtypes[k], make) for k in arrays}
    return make(np.asarray(arrays, np.float32), dtypes)


def _jax(a, dt):
    return jnp.asarray(a, jnp.dtype(dt))


def _torch(a, dt):
    return torch.from_numpy(a).to(getattr(torch, dt))


CASES = [("float32", 1.0, 3), ("float32", 1e-3, 3), ("bfloat16", 1.0, 3),
         ("float32", 1.0, 1), ("float32", 1.0, 9)]


@pytest.mark.parametrize("state_dtype,clip,steps", CASES,
                         ids=["f32-unclipped", "f32-clipped", "bf16-state",
                              "warmup", "past-total"])
def test_adamw_update_matches_jax(state_dtype, clip, steps):
    """``steps`` updates from zero state: clipping off (``clip`` 1) or on
    (``clip`` 1e-3, below the gradients' norm), the warmup's first step,
    and steps past ``total_steps`` (lr 0).  bfloat16 leaves agree bit for
    bit, float32 ones to a few ulps."""
    rng = np.random.default_rng(steps)
    p_np, dts = _tree(rng)
    jcfg = jadamw.AdamWConfig(lr=1e-2, clip_norm=clip,
                              state_dtype=state_dtype, warmup_steps=2,
                              total_steps=8)
    tcfg = tadamw.AdamWConfig(**dataclasses.asdict(jcfg))
    jp, tp = _as(p_np, dts, _jax), _as(p_np, dts, _torch)
    js, ts = jadamw.adamw_init(jp, jcfg), tadamw.adamw_init(tp, tcfg)
    for i in range(steps):
        g_np, _ = _tree(rng, scale=0.01)      # norm about 0.13
        jp, js, jm = jadamw.adamw_update(jp, _as(g_np, dts, _jax), js, jcfg)
        tp, ts, tm = tadamw.adamw_update(tp, _as(g_np, dts, _torch), ts,
                                         tcfg)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for k in ("grad_norm", "lr"):
            assert_allclose(float(tm[k]), float(jm[k]), rtol=F32,
                            err_msg=(i, k))
        for name, j, t in (("params", jp, tp), ("mu", js["mu"], ts["mu"]),
                           ("nu", js["nu"], ts["nu"])):
            for a, b in zip(jax.tree.leaves(j), tree_leaves(t)):
                assert str(a.dtype) == str(b.dtype).split(".")[-1]
                if a.dtype == jnp.bfloat16:     # bit for bit
                    assert_array_equal(_np(b), _np(a), err_msg=(i, name))
                else:
                    assert_allclose(_np(b), _np(a), rtol=F32, atol=1e-7,
                                    err_msg=(i, name))
    if steps > tcfg.total_steps:
        assert float(tm["lr"]) == 0.0


@pytest.mark.parametrize("step", [0, 1, 2, 3, 5, 8, 12])
def test_cosine_schedule_matches_jax(step):
    cfg = jadamw.AdamWConfig(lr=3e-4, warmup_steps=3, total_steps=8)
    want = float(jadamw.cosine_schedule(cfg, jnp.float32(step)))
    got = float(tadamw.cosine_schedule(
        tadamw.AdamWConfig(**dataclasses.asdict(cfg)), step))
    assert_allclose(got, want, rtol=F32, atol=1e-12)


def test_global_norm_matches_jax():
    p_np, dts = _tree(np.random.default_rng(1))
    assert_allclose(float(tadamw.global_norm(_as(p_np, dts, _torch))),
                    float(jadamw.global_norm(_as(p_np, dts, _jax))),
                    rtol=F32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quant_int8_codes_are_bit_equal(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(4096) * 10 ** rng.uniform(-6, 2)).astype(
        np.float32)
    x[:4] = [0.5, -0.5, 1.5, 2.5]      # halves: round to even in both
    jq, js = jcompress._quant_int8(jnp.asarray(x))
    tq, ts = tcompress._quant_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)


def test_ef_int8_allreduce_sim_is_bit_equal():
    p_np, dts = _tree(np.random.default_rng(3))
    want = jcompress.ef_int8_allreduce_sim(_as(p_np, dts, _jax))
    got = tcompress.ef_int8_allreduce_sim(_as(p_np, dts, _torch))
    for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
        assert_array_equal(_np(b), _np(a))


@pytest.mark.parametrize("seed,hosts", [(0, 1), (7, 1), (3, 4)])
def test_synthetic_lm_batches_are_bit_equal(seed, hosts):
    j = jdata.SyntheticLM(503, 96, 8, seed=seed)
    t = tdata.SyntheticLM(503, 96, 8, seed=seed)
    for step in (0, 1, 17):
        for host in range(hosts):
            a = j.batch(step, host_index=host, host_count=hosts)
            b = t.batch(step, host_index=host, host_count=hosts)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                assert_array_equal(b[k], a[k])


@pytest.mark.parametrize("arch", ["qwen3_8b", "whisper_large_v3"])
def test_make_batch_matches_jax(arch):
    """Tokens and labels, and whisper's bfloat16 stub frames."""
    shape = ShapeSpec("t", 32, 2, "train")
    for step in (0, 3):
        want = jdata.make_batch(reduced(get_config(arch)), shape, step)
        got = tdata.make_batch(tconfigs.reduced(tconfigs.get_config(arch)),
                               shape, step, device="cpu")
        assert want.keys() == got.keys()
        for k in want:
            assert got[k].device.type == "cpu"
            assert_array_equal(_np(got[k]), _np(want[k]))
        if "enc_frames" in got:
            assert got["enc_frames"].dtype == torch.bfloat16


def test_make_batch_defaults_to_the_card():
    cfg = tconfigs.reduced(tconfigs.get_config("qwen3_8b"))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdata.make_batch(cfg, ShapeSpec("t", 8, 1, "train"))
