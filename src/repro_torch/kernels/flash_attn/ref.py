"""Plain PyTorch oracle of kernel G: exact grouped-query softmax attention.

Counterpart of ``repro/kernels/flash_attn/ref.py``: ``_sdpa`` with the
causal mask ``i >= j``, or with no mask.  The wrapper in ``flash_attn.py``
runs it on CPU tensors as ``flash_attention_plain``.
"""
from __future__ import annotations

import torch


def causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    """(Sq, Sk) bool, True where key j is visible to query i (i >= j)."""
    i = torch.arange(sq, device=device)
    j = torch.arange(sk, device=device)
    return i[:, None] >= j[None, :]


def flash_attention_ref(q, k, v, *, num_kv_heads: int,
                        causal: bool = True) -> torch.Tensor:
    """q (B, Sq, H, D) over k, v (B, Sk, KV, D), in q's dtype."""
    # Imported here: repro_torch.layers.attention imports the kernel.
    from ...layers.attention import _sdpa

    mask = causal_mask(q.shape[1], k.shape[1], q.device) if causal else None
    return _sdpa(q, k, v, mask, num_kv_heads)
