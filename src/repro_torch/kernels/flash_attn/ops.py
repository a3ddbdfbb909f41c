"""Dispatcher for kernel G.

Counterpart of ``repro/kernels/flash_attn/ops.py``.  ``flash_attention``
is what the attention layer calls: the oracle ``ref.flash_attention_ref``
on a CPU tensor, kernel G (``flash_attn.flash_attention``) on a CUDA
tensor at any Sq and Sk, causal or not.  The choice follows q's device
alone, with no fallback between the two: what the kernel does not take
raises.
"""
from __future__ import annotations

import torch

from . import flash_attn as _kernel
from .ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    num_kv_heads: int, causal: bool = True) -> torch.Tensor:
    """Softmax attention of q (B, Sq, H, D) over k, v (B, Sk, KV, D), in
    q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, num_kv_heads=num_kv_heads,
                                   causal=causal)
    return _kernel.flash_attention(q, k, v, num_kv_heads=num_kv_heads,
                                   causal=causal)
