"""Int8 gradient compression, simulated on one device.

Counterpart of ``repro/train/compress.py``: ``_quant_int8`` and
``ef_int8_allreduce_sim`` (quantize and dequantize every gradient leaf,
the stateless form the train step applies under ``compress_pod_grads``).
``jnp.round`` and ``torch.round`` both round half to even, so the int8
codes agree bit for bit on float32 input.  The JAX package's
``ef_int8_psum`` sums the codes over a pod axis of its mesh and waits for
the port's mesh.
"""
from __future__ import annotations

import torch

from ..core.tree import tree_map


def _quant_int8(x: torch.Tensor):
    """(int8 codes, float32 scale) of x: symmetric, max |x| at 127."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def ef_int8_allreduce_sim(grads):
    """Quantize-dequantize each gradient leaf (error feedback is carried by
    the caller across steps when used in the loop; stateless form here)."""
    def qd(g):
        if g is None:
            return None
        q, s = _quant_int8(g.float())
        return (q.float() * s).to(g.dtype)
    return tree_map(qd, grads)
