"""Dispatcher for kernel H, with its gradient.

Counterpart of ``repro/kernels/ssd/ops.py``.  ``ssd_intra_chunk`` is what
``layers/ssd.py: ssd_chunked`` calls: the oracle ``ref.ssd_intra_chunk_ref``
on a CPU tensor, kernel H (``ssd.ssd_intra_chunk``, in the variant its
dtype selects) on a CUDA tensor.  The choice follows x's device alone,
with no fallback between the two: what the kernel does not take raises.

The call is a ``torch.autograd.Function`` (``SSDIntraChunk``).  Its
backward is plain torch on both devices, as the JAX package has no
backward Pallas kernel: it recomputes the oracle from the saved inputs
under autograd and returns the gradients of all five (``a`` is
``-exp(A_log)``, a trained leaf, and ``dt`` comes from a trained
projection).  The oracle's masked decays are ``exp(-inf) = 0``, whose
gradient is 0.
"""
from __future__ import annotations

import torch

from . import ssd as _kernel
from .ref import ssd_intra_chunk_ref


def ssd_intra_chunk_bwd(x, dt, b, c, a, grad_out):
    """Gradients of the oracle in (x, dt, b, c, a) against ``grad_out``,
    each in its input's dtype."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, dt, b, c, a)]
        y = ssd_intra_chunk_ref(*ins)
        return torch.autograd.grad(y, ins, grad_out)


def _forward(x, dt, b, c, a) -> torch.Tensor:
    if x.device.type == "cpu":
        return ssd_intra_chunk_ref(x, dt, b, c, a)
    return _kernel.ssd_intra_chunk(x, dt, b, c, a)


class SSDIntraChunk(torch.autograd.Function):
    """Kernel H (or the oracle on the CPU) forward; the oracle's gradient
    backward."""

    @staticmethod
    def forward(ctx, x, dt, b, c, a):
        ctx.save_for_backward(x, dt, b, c, a)
        return _forward(x, dt, b, c, a)

    @staticmethod
    def backward(ctx, grad_out):
        return ssd_intra_chunk_bwd(*ctx.saved_tensors, grad_out)


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Y_intra (B, NC, Q, H, P) float32 of x (B, NC, Q, H, P); dt
    (B, NC, Q, H); b, c (B, NC, Q, N); a (H,), differentiable in all
    five."""
    return SSDIntraChunk.apply(x, dt, b, c, a)
