"""Kernel G: flash attention forward (causal or full, grouped-query).

Counterpart of ``repro/kernels/flash_attn/flash_attn.py``
(``flash_attention_pallas``).  On CUDA tensors ``flash_attention``
launches ``csrc/flash_attn.cu`` at every Sq and Sk (the ragged tail is
masked inside the kernel); on CPU tensors it runs
``flash_attention_plain``, which is the JAX oracle
``flash_attention_ref``: ``_sdpa`` with the causal mask ``i >= j``.
There is no fallback between the two: a head_dim, dtype or layout the
kernel does not take raises.

The two differ in rounding, as the Pallas kernel and its oracle do:
``_sdpa`` rounds the scores to the input dtype before its float32
softmax; the kernel keeps them in float32 (it rounds the weights to
bfloat16 for the tensor cores' product with V, as ``_sdpa`` does).  So
bfloat16 agrees to 2e-2, float32 to 3e-5.
"""
from __future__ import annotations

import ctypes

import torch

HEAD_DIMS = (16, 32, 64, 96, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches since the last reset


def causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    """(Sq, Sk) bool, True where key j is visible to query i (i >= j)."""
    i = torch.arange(sq, device=device)
    j = torch.arange(sk, device=device)
    return i[:, None] >= j[None, :]


def flash_attention_plain(q, k, v, *, num_kv_heads: int,
                          causal: bool = True) -> torch.Tensor:
    """Plain version: ``_sdpa`` with the causal mask (or none)."""
    # Imported here: repro_torch.layers.attention imports this module.
    from ...layers.attention import _sdpa

    mask = causal_mask(q.shape[1], k.shape[1], q.device) if causal else None
    return _sdpa(q, k, v, mask, num_kv_heads)


def _check(q, k, v, num_kv_heads: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D: (B, S, heads, head_dim)")
    b, _, h, d = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} != v {tuple(v.shape)}")
    if k.shape[0] != b or k.shape[2] != num_kv_heads or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)} with {num_kv_heads} kv heads")
    if num_kv_heads < 1 or h % num_kv_heads:
        raise ValueError(f"{h} heads are not a multiple of {num_kv_heads} "
                         "kv heads")
    if k.shape[1] < 1:
        raise ValueError("attention needs at least one key")
    devs = {q.device, k.device, v.device}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    num_kv_heads: int, causal: bool = True) -> torch.Tensor:
    """Softmax attention of q (B, Sq, H, D) over k, v (B, Sk, KV, D);
    query head h reads kv head ``h // (H // KV)``, scale ``1/sqrt(D)``.
    Returns (B, Sq, H, D) in q's dtype."""
    _check(q, k, v, num_kv_heads)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, num_kv_heads=num_kv_heads,
                                     causal=causal)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, sq, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} is not one of {HEAD_DIMS}")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} above 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if q.dtype == torch.bfloat16 and t.data_ptr() % 16:
            # The tensor-core path loads 16-byte vectors.
            raise ValueError(f"{name} must start on a 16-byte boundary")
    from .._build import check, load

    fn = load("flash_attn").flash_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 6 + \
        [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, sq, k.shape[1], h, num_kv_heads, d, int(causal),
                 _DTYPES[q.dtype], stream)
    check(err, "flash_attn")
    global launches
    launches += 1
    return out
