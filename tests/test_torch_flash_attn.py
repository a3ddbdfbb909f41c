"""Kernel G's plain version (the port's CPU path) against the JAX
package's Pallas kernel in interpret mode, its oracle, and ``_sdpa`` at a
ragged length the Pallas kernel does not take.  Inputs are NumPy arrays
from a seed, fed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.kernels.flash_attn.flash_attn import flash_attention_pallas
from repro.kernels.flash_attn.ref import flash_attention_ref
from repro.layers.attention import _sdpa as jax_sdpa
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attn import flash_attn as fa
from repro_torch.kernels.flash_attn import ops as fops
from repro_torch.kernels.flash_attn import ref as fref
from repro_torch.layers import attention as tattn

# tests/test_kernels.py's grid, with its tolerances: 3e-5 for float32,
# 2e-2 for bfloat16 (the oracle rounds scores and weights to bf16, the
# kernel keeps float32).
GRID = [(2, 256, 256, 4, 2, 64, True, "float32"),
        (1, 128, 384, 8, 8, 128, False, "float32"),
        (2, 256, 256, 4, 4, 32, True, "float32"),
        (1, 256, 256, 8, 2, 64, True, "bfloat16")]
TOL = {"float32": 3e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(b, sq, sk, h, kv, d, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]
    return ([jnp.asarray(a, JDT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TDT[dtype]) for a in arrs])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,dtype", GRID)
def test_plain_matches_pallas_interpret(b, sq, sk, h, kv, d, causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(b, sq, sk, h, kv, d, dtype, sq + d)
    want = flash_attention_pallas(jq, jk, jv, num_kv_heads=kv,
                                  causal=causal, interpret=True)
    got = fa.flash_attention_plain(tq, tk, tv, num_kv_heads=kv,
                                   causal=causal)
    assert got.dtype == TDT[dtype] and got.shape == (b, sq, h, d)
    assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,dtype", GRID)
def test_wrapper_on_cpu_matches_oracle(b, sq, sk, h, kv, d, causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(b, sq, sk, h, kv, d, dtype, sk + h)
    want = flash_attention_ref(jq, jk, jv, num_kv_heads=kv, causal=causal)
    reset_launch_counts()
    got = fops.flash_attention(tq, tk, tv, num_kv_heads=kv, causal=causal)
    assert launch_counts()["flash_attn"] == 0          # the CPU runs the plain version
    assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype], atol=TOL[dtype])
    with pytest.raises(ValueError, match="CUDA"):   # the kernel's own
        fa.flash_attention(tq, tk, tv, num_kv_heads=kv, causal=causal)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kv,d", [(4, 2, 16), (4, 4, 96)])
def test_ragged_length_matches_jax_sdpa(dtype, h, kv, d):
    """Sq = Sk = 100: the Pallas kernel asserts multiples of 128, so the
    port is held to the JAX ``_sdpa`` with the causal mask, and to the
    layer's ``_sdpa_chunked``."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(2, 100, 100, h, kv, d, dtype, 100)
    i = jnp.arange(100)
    want = jax_sdpa(jq, jk, jv, (i[:, None] >= i[None, :])[None, None, None],
                    kv)
    got = fops.flash_attention(tq, tk, tv, num_kv_heads=kv, causal=True)
    assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype], atol=TOL[dtype])
    chunked = tattn._sdpa_chunked(tq, tk, tv, kv, causal=True)
    assert torch.equal(chunked, got)


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,dtype", [
    (2, 37, 37, 4, 2, 16, True, "float32"),
    (2, 5, 24, 4, 4, 16, False, "float32"),       # whisper's cross shape
    (1, 24, 24, 4, 4, 16, False, "bfloat16")])    # its encoder's
def test_ref_and_ops_match_jax_ref(b, sq, sk, h, kv, d, causal, dtype):
    """``ref.flash_attention_ref`` against ``repro``'s, causal and not,
    at Sq != Sk; ``ops.flash_attention`` takes it on the CPU."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(b, sq, sk, h, kv, d, dtype, sk)
    want = flash_attention_ref(jq, jk, jv, num_kv_heads=kv, causal=causal)
    got = fref.flash_attention_ref(tq, tk, tv, num_kv_heads=kv,
                                   causal=causal)
    assert got.dtype == TDT[dtype] and got.shape == (b, sq, h, d)
    assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype], atol=TOL[dtype])
    reset_launch_counts()
    assert torch.equal(fops.flash_attention(tq, tk, tv, num_kv_heads=kv,
                                            causal=causal), got)
    assert launch_counts()["flash_attn"] == 0
    assert fa.flash_attention_plain is fref.flash_attention_ref


def test_causal_mask_is_lower_triangle_from_zero():
    m = fa.causal_mask(3, 5, "cpu")
    assert m.tolist() == [[True, False, False, False, False],
                          [True, True, False, False, False],
                          [True, True, True, False, False]]


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros(1, 8, 4, 16)
    kv = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):
        fa.flash_attention(q, kv, kv[:, :4], num_kv_heads=2)
    with pytest.raises(ValueError):
        fa.flash_attention(q, kv, kv, num_kv_heads=3)
    with pytest.raises(ValueError):
        fa.flash_attention(q[0], kv, kv, num_kv_heads=2)
    with pytest.raises(ValueError):
        fa.flash_attention(q, kv[:, :0], kv[:, :0], num_kv_heads=2)


@pytest.mark.parametrize("dtype,d,variant", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "mma_sync"), (torch.bfloat16, 32, "mma_sync"),
    (torch.bfloat16, 96, "mma_sync"), (torch.float32, 64, "cuda_cores"),
    (torch.float32, 128, "cuda_cores")])
def test_variant_is_chosen_by_dtype_and_head_dim(dtype, d, variant):
    assert fa.variant_for(dtype, d) == variant
    assert variant in fa.launches_by_variant


def test_variant_rejects_other_dtypes():
    with pytest.raises(TypeError):
        fa.variant_for(torch.float16, 64)


def test_tma_strides_of_the_zamba2_and_gqa_shapes():
    assert fa.tma_strides((4, 2048, 32, 64), 2, 0) == (128, 4096, 8388608)
    assert fa.tma_strides((1, 2048, 8, 128), 2, 4096) == (256, 2048, 4194304)


@pytest.mark.parametrize("shape,ptr", [
    ((1, 8, 4, 64), 8),                 # base not 16-byte aligned
    ((1, 8, 3, 4), 0),                  # 8-byte rows
    ((1, 1 << 28, 64, 64), 0),          # a batch stride of 2^41 bytes
    ((1, 1, (1 << 32) + 1, 64), 0)])    # an extent above 2^32
def test_tma_strides_reject_what_tma_cannot_read(shape, ptr):
    with pytest.raises(ValueError):
        fa.tma_strides(shape, 2, ptr)
