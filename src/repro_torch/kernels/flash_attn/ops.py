"""Dispatcher for kernel G, with its gradient.

Counterpart of ``repro/kernels/flash_attn/ops.py``.  ``flash_attention``
is what the attention layer calls: the oracle ``ref.flash_attention_ref``
on a CPU tensor, kernel G (``flash_attn.flash_attention``) on a CUDA
tensor at any Sq and Sk, causal or not.  The choice follows q's device
alone, with no fallback between the two: what the kernel does not take
raises.

The forward is the custom op ``repro_torch::flash_attention_fwd``, whose
fake kernel gives the output's shape and dtype (a dry-run under
``FakeTensorMode`` traces no (B, H, Sq, Sk) scores).  On DTensors
(``torch.distributed.tensor``) the call goes through ``local_map``: each
rank runs the kernel on its own batch rows and heads (``_sharded``), and
no DTensor reaches the kernel's wrapper.

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

from ...distributed.sharding import check_placements, is_dtensor, \
    local_range
from . import flash_attn as _kernel
from .ref import flash_attention_ref

Q_BLOCK = 128       # repro/layers/attention.py: ATTN_Q_BLOCK


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             num_kv_heads: int, causal: bool) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, num_kv_heads=num_kv_heads,
                                   causal=causal)
    return _kernel.flash_attention(q, k, v, num_kv_heads=num_kv_heads,
                                   causal=causal)


@_forward.register_fake
def _(q, k, v, num_kv_heads, causal):
    return q.new_empty(q.shape)


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


def _sharded(q, k, v, num_kv_heads: int, causal: bool):
    """``flash_attention`` of DTensors, each rank on its local shard.

    q may be split on its batch (dim 0) and heads (dim 2), k and v on
    theirs; any other placement raises.  k and v follow q's batch split.
    Where q's heads are split and k's are not (kv heads that the mesh axis
    does not divide), each rank takes the kv heads its q heads read, and
    their gradient is a partial sum over that axis."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    for name, t in (("q", q), ("k", k), ("v", v)):
        check_placements(f"flash_attention {name}", t, (0, 2))
    mesh = q.device_mesh
    qp = tuple(q.placements)
    # k and v take q's batch split and, where q's heads are replicated,
    # its replicated heads.
    kp = tuple(Shard(0) if a == Shard(0) else
               (b if a == Shard(2) else Replicate())
               for a, b in zip(qp, k.placements))
    k, v = k.redistribute(mesh, kp), v.redistribute(mesh, kp)
    kv_grad = tuple(Partial() if a == Shard(2) and b == Replicate() else b
                    for a, b in zip(qp, kp))
    slice_kv = kv_grad != kp
    g = q.shape[2] // num_kv_heads
    h0, h1 = local_range(q, 2)
    kv0, kv1 = (h0 // g, (h1 - 1) // g + 1) if slice_kv else (0, 0)

    def local(ql, kl, vl):
        if slice_kv:
            kl, vl = kl[:, :, kv0:kv1], vl[:, :, kv0:kv1]
        n_kv = kl.shape[2]
        if ql.shape[2] % n_kv:
            raise ValueError(f"local heads {h0}:{h1} do not share whole kv "
                             f"heads (group {g})")
        return FlashAttention.apply(ql, kl.contiguous(), vl.contiguous(),
                                    n_kv, causal)

    return local_map(local, out_placements=list(qp), in_placements=(qp, kp, kp),
                     in_grad_placements=(qp, kv_grad, kv_grad),
                     device_mesh=mesh)(q, k, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    num_kv_heads: int, causal: bool = True) -> torch.Tensor:
    """Softmax attention of q (B, Sq, H, D) over k, v (B, Sk, KV, D), in
    q's dtype, differentiable in q, k and v."""
    if is_dtensor(q):
        return _sharded(q, k, v, num_kv_heads, causal)
    return FlashAttention.apply(q, k, v, num_kv_heads, causal)
