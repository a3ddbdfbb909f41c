"""Kernel G: flash attention forward (causal or full, grouped-query).

Counterpart of ``repro/kernels/flash_attn/flash_attn.py``
(``flash_attention_pallas``).  ``flash_attention`` launches
``csrc/flash_attn.cu`` on CUDA tensors at every Sq and Sk (the ragged
tail is masked inside the kernel) and raises on any other device:
``ops.flash_attention`` runs the oracle on CPU tensors.  The oracle
``ref.flash_attention_ref`` (the JAX package's ``flash_attention_ref``:
``_sdpa`` with the causal mask ``i >= j``, or with none) is re-exported
here as ``flash_attention_plain``.  A head_dim, dtype or layout the
kernel does not take raises.

The kernel has three variants, chosen by ``variant_for`` from the dtype
and head_dim alone: ``wgmma`` (bfloat16, D 64 and 128: warpgroup MMA fed
by TMA), ``mma_sync`` (bfloat16, D 16, 32, 96) and ``cuda_cores``
(float32).  ``launches_by_variant`` counts each.  TMA reads the tensors
through 4-D maps, so ``tma_strides`` checks the strides and alignment it
needs before the launch.

The two differ in rounding, as the Pallas kernel and its oracle do:
``_sdpa`` rounds the scores to the input dtype before its float32
softmax; the kernel keeps them in float32 (it rounds the weights to
bfloat16 for the tensor cores' product with V, as ``_sdpa`` does).  So
bfloat16 agrees to 2e-2, float32 to 3e-5.
"""
from __future__ import annotations

import torch

from .._build import I32, I64, PTR, kernel, launch, variant_counts
from .ref import causal_mask  # noqa: F401
from .ref import flash_attention_ref as flash_attention_plain  # noqa: F401

HEAD_DIMS = (16, 32, 64, 96, 128)
WGMMA_HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("cuda_cores", "mma_sync", "wgmma")   # the kernel's codes 0-2

launches_by_variant = variant_counts("flash_attn", VARIANTS)


def variant_for(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel variant that serves ``dtype`` at ``head_dim``."""
    if dtype == torch.float32:
        return "cuda_cores"
    if dtype != torch.bfloat16:
        raise TypeError(f"no kernel variant for {dtype}")
    return "wgmma" if head_dim in WGMMA_HEAD_DIMS else "mma_sync"


def tma_strides(shape, itemsize: int, data_ptr: int) -> tuple[int, ...]:
    """Byte strides of the 4-D TMA map over a contiguous (B, S, heads, D)
    tensor, dims above the innermost.  Raises unless TMA can read it: the
    base 16-byte aligned, every stride a multiple of 16 below 2^40 and
    every extent at most 2^32."""
    b, s, heads, d = shape
    if data_ptr % 16:
        raise ValueError("TMA needs a 16-byte-aligned base address")
    if max(shape) > 1 << 32:
        raise ValueError(f"extent above 2^32 in {tuple(shape)}")
    strides = (d * itemsize, heads * d * itemsize, s * heads * d * itemsize)
    for st in strides:
        if st % 16 or st >= 1 << 40:
            raise ValueError(f"TMA stride {st} B is not a multiple of 16 "
                             "below 2^40")
    return strides


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


_counters: dict = {}


def _counter(dev: torch.device) -> int:
    """Address of the wgmma variant's tile counter on ``dev``: 8 bytes
    that each launch zeroes on its stream before its blocks count tiles
    off it (so launches on one stream may share it)."""
    held = _counters.get(dev)
    if held is None:
        buf = torch.empty(1, dtype=torch.int64, device=dev)
        _counters[dev] = held = (buf, buf.data_ptr())
    return held[1]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    num_kv_heads: int, causal: bool = True) -> torch.Tensor:
    """Softmax attention of q (B, Sq, H, D) over k, v (B, Sk, KV, D);
    query head h reads kv head ``h // (H // KV)``, scale ``1/sqrt(D)``.
    Returns (B, Sq, H, D) in q's dtype."""
    _check(q, k, v, num_kv_heads)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"kernel G runs on CUDA tensors, not {dev} "
                         "(ops.flash_attention takes CPU tensors)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, sq, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} is not one of {HEAD_DIMS}")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} above 65535")
    variant = variant_for(q.dtype, d)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if variant == "wgmma":
            tma_strides(t.shape, t.element_size(), t.data_ptr())
        elif q.dtype == torch.bfloat16 and t.data_ptr() % 16:
            # The tensor-core paths move 16-byte vectors.
            raise ValueError(f"{name} must start on a 16-byte boundary")
    out = torch.empty_like(q)
    counter = _counter(dev) if variant == "wgmma" else None
    launch(kernel("flash_attn", "flash_attn_fwd", *[PTR] * 4, *[I64] * 6,
                  I32, I32, I32, PTR, PTR),
           dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
           sq, k.shape[1], h, num_kv_heads, d, int(causal), _DTYPES[q.dtype],
           VARIANTS.index(variant), counter, variant=variant)
    return out
