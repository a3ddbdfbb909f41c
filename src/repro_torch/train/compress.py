"""Error-feedback int8 gradient compression for the slow ("pod") axis.

Counterpart of ``repro/train/compress.py``: ``_quant_int8``,
``ef_int8_allreduce_sim`` (quantize and dequantize every gradient leaf,
the stateless form the train step applies under ``compress_pod_grads``)
and ``ef_int8_psum``, the JAX package's ``shard_map`` form: each rank
quantizes its own gradient plus its residual and the dequantized values
are summed over the mesh's pod axis with ``all_reduce``.  ``jnp.round``
and ``torch.round`` both round half to even, so the int8 codes agree bit
for bit on float32 input.
"""
from __future__ import annotations

import torch

from ..core.tree import tree_map


def _quant_int8(x: torch.Tensor):
    """(int8 codes, float32 scale) of x: symmetric, max |x| at 127."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def residual_of(gf: torch.Tensor, q: torch.Tensor,
                s: torch.Tensor) -> torch.Tensor:
    """``gf - q * s`` rounded once to float32, as XLA's fused
    multiply-add gives it: exact in float64 (q * s has at most 31
    significant bits, and gf is near it or q is 0), then rounded."""
    return (gf.double() - q.double() * s.double()).float()


def ef_int8_allreduce_sim(grads):
    """Quantize-dequantize each gradient leaf (error feedback is carried by
    the caller across steps when used in the loop; stateless form here)."""
    def qd(g):
        if g is None:
            return None
        q, s = _quant_int8(g.float())
        return (q.float() * s).to(g.dtype)
    return tree_map(qd, grads)


def ef_int8_psum(grads, residual, axis_name: str = "pod", *, mesh=None):
    """Int8 psum over ``mesh``'s ``axis_name`` (the ``shard_ctx`` mesh by
    default) with error feedback: each leaf of ``grads`` is this rank's
    gradient (a DTensor counts by its local shard, as a ``shard_map``
    body sees it), ``residual`` the float32 residual beside it.  Returns
    (summed grads in each leaf's dtype, new float32 residual)."""
    import torch.distributed as dist

    from ..distributed.sharding import current_mesh, is_dtensor

    mesh = mesh if mesh is not None else current_mesh()
    group = mesh.get_group(axis_name)

    new_res = []

    def one(g, r):
        g = g.to_local() if is_dtensor(g) else g
        r = r.to_local() if is_dtensor(r) else r
        gf = g.float() + r
        q, s = _quant_int8(gf)
        deq = q.float() * s
        new_res.append(residual_of(gf, q, s))
        dist.all_reduce(deq, group=group)
        return deq.to(g.dtype)

    summed = tree_map(one, grads, residual)
    res = iter(new_res)      # tree_map visits the leaves in one order
    return summed, tree_map(lambda _: next(res), summed)
