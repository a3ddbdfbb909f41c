"""Dispatcher for kernel G, with its gradient.

Counterpart of ``repro/kernels/flash_attn/ops.py``.  ``flash_attention``
is what the attention layer calls: the oracle ``ref.flash_attention_ref``
on a CPU tensor, kernel G (``flash_attn.flash_attention``) on a CUDA
tensor at any Sq and Sk, causal or not.  The choice follows q's device
alone, with no fallback between the two: what the kernel does not take
raises.

The call is a ``torch.autograd.Function`` (``FlashAttention``).  Its
backward is plain torch on both devices, as the JAX package has no
backward Pallas kernel: it recomputes the oracle from the saved q, k, v
one block of ``Q_BLOCK`` query rows at a time (the JAX package's
``ATTN_Q_BLOCK`` remat), so that (B, H, Q_BLOCK, Sk) is the largest score
tensor, and takes its gradient there.  A causal block sees only the keys
up to its last row, so the keys past it are left out of its recompute.
"""
from __future__ import annotations

import torch

from . import flash_attn as _kernel
from .ref import flash_attention_ref

Q_BLOCK = 128       # repro/layers/attention.py: ATTN_Q_BLOCK


def _forward(q, k, v, num_kv_heads: int, causal: bool) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, num_kv_heads=num_kv_heads,
                                   causal=causal)
    return _kernel.flash_attention(q, k, v, num_kv_heads=num_kv_heads,
                                   causal=causal)


def flash_attention_bwd(q, k, v, grad_out, *, num_kv_heads: int,
                        causal: bool = True):
    """(dq, dk, dv) of the oracle at (q, k, v) against ``grad_out``,
    recomputed ``Q_BLOCK`` query rows at a time; dk and dv are summed in
    float32 over the blocks."""
    from ...layers.attention import _sdpa

    sq, sk = q.shape[1], k.shape[1]
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    for i0 in range(0, sq, Q_BLOCK):
        i1 = min(i0 + Q_BLOCK, sq)
        # Query i sees keys j <= i under the causal mask.
        n_k = min(i1, sk) if causal else sk
        with torch.enable_grad():
            qb = q[:, i0:i1].detach().requires_grad_()
            kb = k[:, :n_k].detach().requires_grad_()
            vb = v[:, :n_k].detach().requires_grad_()
            mask = None
            if causal:
                rows = torch.arange(i0, i1, device=q.device)
                mask = rows[:, None] >= torch.arange(n_k, device=q.device)
            out = _sdpa(qb, kb, vb, mask, num_kv_heads)
            gq, gk, gv = torch.autograd.grad(out, (qb, kb, vb),
                                             grad_out[:, i0:i1])
        dq[:, i0:i1] = gq
        dk[:, :n_k] += gk.float()
        dv[:, :n_k] += gv.float()
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """Kernel G (or the oracle on the CPU) forward; the oracle's gradient,
    recomputed blockwise, backward."""

    @staticmethod
    def forward(ctx, q, k, v, num_kv_heads: int, causal: bool):
        ctx.save_for_backward(q, k, v)
        ctx.num_kv_heads, ctx.causal = num_kv_heads, causal
        return _forward(q, k, v, num_kv_heads, causal)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, grad_out.contiguous(), num_kv_heads=ctx.num_kv_heads,
            causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    num_kv_heads: int, causal: bool = True) -> torch.Tensor:
    """Softmax attention of q (B, Sq, H, D) over k, v (B, Sk, KV, D), in
    q's dtype, differentiable in q, k and v."""
    return FlashAttention.apply(q, k, v, num_kv_heads, causal)
