"""Kernel H's plain version and the port's Mamba2 layer against the JAX
package: the Pallas kernel in interpret mode, ``ssd_chunked`` (with its
tail padding), ``_causal_conv``, ``ssd_decode_step`` and ``mamba_block``
with carried weights.  Inputs are NumPy arrays from a seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.configs import get_config, reduced
from repro.kernels.ssd.ref import ssd_intra_chunk_ref
from repro.kernels.ssd.ssd import ssd_intra_chunk_pallas
from repro.layers import ssd as jssd
from repro.models.params import materialize as jmaterialize
from repro_torch.core.interop import _tensors_like
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.ssd import ops as tops
from repro_torch.kernels.ssd import ref as tref
from repro_torch.kernels.ssd import ssd as tker
from repro_torch.layers import ssd as tssd
from repro_torch.models.transformer import Params

# tests/test_kernels.py's grid and tolerances: 2e-4 for float32, 3e-2 for
# bfloat16.  The port returns float32 (what ssd_chunked needs); the JAX
# side is cast to float32 to compare.
GRID = [(2, 3, 64, 4, 32, 16, "float32"), (1, 2, 128, 8, 64, 64, "float32"),
        (1, 2, 128, 4, 64, 128, "bfloat16")]
TOL = {"float32": 2e-4, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
F32 = 1e-5   # float32 layer math against float32 layer math


def _both(a, dtype="float32"):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _kernel_inputs(bs, nc, q, h, p, n, dtype, seed):
    rng = np.random.default_rng(seed)
    x = _both(rng.standard_normal((bs, nc, q, h, p)), dtype)
    dt = _both(rng.uniform(0.01, 0.2, (bs, nc, q, h)))
    b = _both(rng.standard_normal((bs, nc, q, n)), dtype)
    c = _both(rng.standard_normal((bs, nc, q, n)), dtype)
    a = _both(-np.exp(rng.standard_normal(h) * 0.3))
    return [t[0] for t in (x, dt, b, c, a)], [t[1] for t in (x, dt, b, c, a)]


@pytest.mark.parametrize("bs,nc,q,h,p,n,dtype", GRID)
def test_plain_matches_pallas_interpret(bs, nc, q, h, p, n, dtype):
    jin, tin = _kernel_inputs(bs, nc, q, h, p, n, dtype, q + n)
    want = ssd_intra_chunk_pallas(*jin, interpret=True)
    got = tker.ssd_intra_chunk_plain(*tin)
    assert got.dtype == torch.float32 and got.shape == (bs, nc, q, h, p)
    assert_allclose(_np(got), _np(want), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("bs,nc,q,h,p,n,dtype", GRID)
def test_wrapper_on_cpu_matches_oracle(bs, nc, q, h, p, n, dtype):
    jin, tin = _kernel_inputs(bs, nc, q, h, p, n, dtype, q + h)
    reset_launch_counts()
    got = tops.ssd_intra_chunk(*tin)
    assert launch_counts()["ssd_intra_chunk"] == 0        # the CPU runs the plain version
    assert_allclose(_np(got), _np(ssd_intra_chunk_ref(*jin)),
                    rtol=TOL[dtype], atol=TOL[dtype])
    with pytest.raises(ValueError, match="CUDA"):   # the kernel's own
        tker.ssd_intra_chunk(*tin)


@pytest.mark.parametrize("bs,nc,q,h,p,n,dtype", [
    (2, 3, 16, 4, 16, 16, "float32"), (1, 2, 37, 2, 32, 64, "bfloat16")])
def test_ref_and_ops_match_jax_ref(bs, nc, q, h, p, n, dtype):
    """``ref.ssd_intra_chunk_ref`` against ``repro``'s (which returns x's
    dtype; the port's float32), at a ragged chunk too; ``ops`` takes it on
    the CPU."""
    jin, tin = _kernel_inputs(bs, nc, q, h, p, n, dtype, q + p)
    got = tref.ssd_intra_chunk_ref(*tin)
    assert got.dtype == torch.float32 and got.shape == (bs, nc, q, h, p)
    assert_allclose(_np(got), _np(ssd_intra_chunk_ref(*jin)),
                    rtol=TOL[dtype], atol=TOL[dtype])
    reset_launch_counts()
    assert torch.equal(tops.ssd_intra_chunk(*tin), got)
    assert launch_counts()["ssd_intra_chunk"] == 0
    assert tker.ssd_intra_chunk_plain is tref.ssd_intra_chunk_ref


def test_wrapper_rejects_bad_shapes():
    _, (x, dt, b, c, a) = _kernel_inputs(1, 2, 16, 4, 16, 16, "float32", 0)
    with pytest.raises(ValueError):
        tker.ssd_intra_chunk(x, dt[:, :1], b, c, a)
    with pytest.raises(ValueError):
        tker.ssd_intra_chunk(x, dt, b, c[..., :8], a)
    with pytest.raises(ValueError):
        tker.ssd_intra_chunk(x, dt, b, c, a[:2])
    with pytest.raises(ValueError):
        tker.ssd_intra_chunk(x[0], dt, b, c, a)


def test_segsum_matches_jax():
    a = np.random.default_rng(3).standard_normal((2, 3, 9)).astype(
        np.float32)
    want = np.asarray(jssd._segsum(jnp.asarray(a)))
    got = tssd._segsum(torch.from_numpy(a)).numpy()
    assert np.array_equal(np.isinf(want), np.isinf(got))
    fin = np.isfinite(want)
    assert_allclose(got[fin], want[fin], rtol=F32, atol=F32)


@pytest.mark.parametrize("l0,chunk", [(37, 16), (64, 16), (5, 16)])
def test_ssd_chunked_matches_jax(l0, chunk):
    """l0 = 37 at chunk 16 pads the tail with dt = 0; 5 < chunk gives one
    short chunk.  Output and final state both."""
    rng = np.random.default_rng(l0)
    b, h, p, n = 2, 4, 16, 16
    x = _both(rng.standard_normal((b, l0, h, p)))
    dt = _both(rng.uniform(0.01, 0.5, (b, l0, h)))
    a = _both(-np.exp(rng.standard_normal(h) * 0.3))
    bb = _both(rng.standard_normal((b, l0, n)))
    cc = _both(rng.standard_normal((b, l0, n)))
    jy, jh = jssd.ssd_chunked(x[0], dt[0], a[0], bb[0], cc[0], chunk)
    ty, th = tssd.ssd_chunked(x[1], dt[1], a[1], bb[1], cc[1], chunk)
    assert ty.shape == (b, l0, h, p) and th.shape == (b, h, p, n)
    assert_allclose(_np(ty), _np(jy), rtol=F32, atol=F32)
    assert_allclose(_np(th), _np(jh), rtol=F32, atol=F32)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(7)
    x = _both(rng.standard_normal((2, 6, 8)))
    w = _both(rng.standard_normal((4, 8)) * 0.5)
    st = _both(rng.standard_normal((2, 3, 8))) if with_state else (None,
                                                                     None)
    jy, js = jssd._causal_conv(x[0], w[0], st[0])
    ty, ts = tssd._causal_conv(x[1], w[1], st[1])
    assert_allclose(_np(ty), _np(jy), rtol=F32, atol=F32)
    assert_allclose(_np(ts), _np(js), rtol=0, atol=0)


def test_ssd_decode_step_matches_jax():
    rng = np.random.default_rng(11)
    b, h, p, n = 2, 4, 16, 16
    args = [_both(rng.standard_normal((b, h, p))),
            _both(rng.uniform(0.01, 0.5, (b, h))),
            _both(-np.exp(rng.standard_normal(h) * 0.3)),
            _both(rng.standard_normal((b, n))),
            _both(rng.standard_normal((b, n))),
            _both(rng.standard_normal((b, h, p, n)))]
    jy, jh = jssd.ssd_decode_step(*(a[0] for a in args))
    ty, th = tssd.ssd_decode_step(*(a[1] for a in args))
    assert_allclose(_np(ty), _np(jy), rtol=F32, atol=F32)
    assert_allclose(_np(th), _np(jh), rtol=F32, atol=F32)


@pytest.fixture(scope="module")
def mamba():
    """Reduced Zamba2's Mamba2 weights from the JAX init, carried over."""
    cfg = dataclasses.replace(reduced(get_config("zamba2_1_2b")),
                              dtype="float32")
    specs = jssd.ssd_specs(cfg)
    jp = jmaterialize(specs, jax.random.PRNGKey(5), jnp.float32)
    tree = jax.tree.map(lambda v: np.asarray(v, np.float32), jp)
    from repro_torch.configs import get_config as tget, reduced as tred
    tcfg = dataclasses.replace(tred(tget("zamba2_1_2b")), dtype="float32")
    tp = Params(_tensors_like(tssd.ssd_specs(tcfg), tree, "float32", "cpu"))
    return cfg, jp, tcfg, tp


def test_mamba_block_prefill_and_decode_match_jax(mamba):
    cfg, jp, tcfg, tp = mamba
    rng = np.random.default_rng(13)
    x = _both(rng.standard_normal((2, 37, cfg.d_model)))
    jy, jst = jssd.mamba_block(jp, cfg, x[0])
    ty, tst = tssd.mamba_block(tp, tcfg, x[1])
    assert_allclose(_np(ty), _np(jy), rtol=1e-4, atol=1e-4)
    for k in ("ssm", "conv_x", "conv_b", "conv_c"):
        assert_allclose(_np(tst[k]), _np(jst[k]), rtol=1e-4, atol=1e-4)
    x1 = _both(rng.standard_normal((2, 1, cfg.d_model)))
    jy1, jst1 = jssd.mamba_block(jp, cfg, x1[0], jst)
    ty1, tst1 = tssd.mamba_block(tp, tcfg, x1[1], tst)
    assert_allclose(_np(ty1), _np(jy1), rtol=1e-4, atol=1e-4)
    assert_allclose(_np(tst1["ssm"]), _np(jst1["ssm"]), rtol=1e-4,
                    atol=1e-4)
