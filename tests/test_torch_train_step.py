"""The port's training path against the JAX package on the CPU, part 2:
``make_train_step`` over three steps against the JAX package's, reduced
Zamba2 at one and two microbatches and reduced Qwen3 with compressed
gradients (the compression does not depend on the model, and Qwen3's
JAX step compiles in a fifth of Zamba2's time), then the loss falling
on structured data as tests/test_archs.py checks it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import repro_torch.configs as tconfigs
from _torch_train_cases import mesh  # noqa: F401  (a fixture)
from _torch_train_cases import (LOSS_REL, batch_np, carried, cfgs, jbatch,
                                tbatch, worst_leaves)
from repro.distributed.sharding import TRAIN_RULES
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jadamw_init
from repro.train import step as jstep
from repro_torch.configs import ShapeSpec
from repro_torch.core import interop
from repro_torch.data.pipeline import make_batch
from repro_torch.models import transformer as ttfm
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train import step as tstep


# -- make_train_step ---------------------------------------------------------

STEP_CASES = [("zamba2_1_2b", 1, False), ("zamba2_1_2b", 2, False),
              ("qwen3_8b", 1, True)]
# Per leaf after each step, RMS(port - JAX) / RMS(JAX param), and the
# relative grad_norm.  Readings: 4e-6 to 2e-5 and 1.4e-6 at 1 and 2
# microbatches.  Compressed, an int8 code that rounds the other way moves
# its element's gradient by a whole code (max|g| / 127): 1e-3 (tail
# dt_bias, zero at init) and 1.8e-5 by step 3.
PARAM_REL = {False: 2e-4, True: 1e-2}
GNORM_REL = {False: 1e-5, True: 2e-4}


@pytest.mark.parametrize("arch,accum,compress", STEP_CASES,
                         ids=["accum1", "accum2", "compress"])
def test_train_step_matches_jax_over_three_steps(arch, accum, compress,
                                                 mesh):
    jcfg, tcfg = cfgs(arch)
    jp, lm = carried(jcfg, tcfg, seed=13)
    jopt = JAdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    topt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    js = jadamw_init(jp, jopt)
    ts = adamw_init(lm, topt)
    jfn = jax.jit(jstep.make_train_step(jcfg, mesh, TRAIN_RULES, jopt,
                                        accum_steps=accum,
                                        compress_pod_grads=compress))
    tfn = tstep.make_train_step(tcfg, None, None, topt, accum_steps=accum,
                                compress_pod_grads=compress)
    for i in range(3):
        b = batch_np(tcfg, 4, 32, step=i)
        jp, js, jm = jfn(jp, js, jbatch(b, jnp.float32))
        lm, ts, tm = tfn(lm, ts, tbatch(b, torch.float32))
        for k in ("loss", "aux_loss", "tokens", "lr"):
            assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_REL,
                            atol=1e-7, err_msg=(i, k))
        assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                        rtol=GNORM_REL[compress], err_msg=i)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        worst = worst_leaves(interop.lm_params_to_numpy(tcfg, lm),
                             jax.tree.map(lambda x: np.asarray(x, np.float32),
                                          jp))
        assert worst[0][1] < PARAM_REL[compress], (i, worst)


def test_loss_decreases_on_structured_data():
    """tests/test_archs.py's check on the port: reduced Qwen3 (bfloat16),
    seed 3, 16 steps of 4 x 128, window means of the first and last 4."""
    cfg = tconfigs.reduced(tconfigs.get_config("qwen3_8b"))
    lm = ttfm.init_params(cfg, torch.Generator().manual_seed(3),
                          device="cpu")
    opt = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=50)
    state = adamw_init(lm, opt)
    step = tstep.make_train_step(cfg, None, None, opt)
    losses = []
    for i in range(16):
        batch = make_batch(cfg, ShapeSpec("t", 128, 4, "train"), step=i,
                           device="cpu")
        lm, state, m = step(lm, state, batch)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-4:]) < np.mean(losses[:4]) - 0.2, losses
