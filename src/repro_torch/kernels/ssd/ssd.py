"""Kernel H: the Mamba2 SSD intra-chunk term.

Counterpart of ``repro/kernels/ssd/ssd.py`` (``ssd_intra_chunk_pallas``).
Per (batch, chunk, head):

    Y = (L o C B^T) diag(dt) X,   L[i, j] = exp(sum_{j<k<=i} dt_k A)

zero above the diagonal.  ``ssd_intra_chunk`` launches
``csrc/ssd_intra_chunk.cu`` on CUDA tensors at any chunk length up to 256
and raises on any other device: ``ops.ssd_intra_chunk`` runs the oracle
on CPU tensors.  The oracle ``ref.ssd_intra_chunk_ref`` (the JAX
package's: the einsums of ``ssd_chunked``) is re-exported here as
``ssd_intra_chunk_plain``.

Output dtype: float32 always, what ``ssd_chunked`` needs (it adds the
inter-chunk term before it casts).  The Pallas kernel and its oracle
return x's dtype; the port's tests compare against them cast to float32.

The kernel has two variants, chosen by ``variant_for`` from the dtype
alone: ``wgmma`` (bfloat16: both products on the tensor cores, operands
brought in by TMA) and ``cuda_cores`` (float32, which TF32 would round
past its 2e-4 limit).  ``launches_by_variant`` counts each.  A caller may
ask for ``cuda_cores`` on bfloat16 inputs too, to compare the two.
"""
from __future__ import annotations

import torch

from .._build import I32, I64, PTR, kernel, launch, variant_counts
from .ref import ssd_intra_chunk_ref as ssd_intra_chunk_plain  # noqa: F401

HEAD_DIMS = (16, 32, 64)
STATE_DIMS = (16, 64, 128)
MAX_CHUNK = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("cuda_cores", "wgmma")   # the kernel's codes 0-1

launches_by_variant = variant_counts("ssd_intra_chunk", VARIANTS)


def variant_for(dtype: torch.dtype) -> str:
    """The kernel variant that serves inputs of ``dtype``."""
    if dtype == torch.float32:
        return "cuda_cores"
    if dtype == torch.bfloat16:
        return "wgmma"
    raise TypeError(f"no kernel variant for {dtype}")


def _check(x, dt, b, c, a) -> None:
    if x.dim() != 5:
        raise ValueError("x must be (B, NC, Q, H, P)")
    bs, nc, q, h, _ = x.shape
    if tuple(dt.shape) != (bs, nc, q, h):
        raise ValueError(f"dt {tuple(dt.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    if b.shape != c.shape or b.dim() != 4 or tuple(b.shape[:3]) != (bs, nc,
                                                                    q):
        raise ValueError(f"b {tuple(b.shape)}, c {tuple(c.shape)} do not "
                         f"fit x {tuple(x.shape)}")
    if tuple(a.shape) != (h,):
        raise ValueError(f"a {tuple(a.shape)} is not ({h},)")
    devs = {t.device for t in (x, dt, b, c, a)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor, a: torch.Tensor, *,
                    variant: str | None = None) -> torch.Tensor:
    """Y_intra (B, NC, Q, H, P) float32 of x (B, NC, Q, H, P); dt
    (B, NC, Q, H) float32; b, c (B, NC, Q, N) of x's dtype; a (H,)
    float32 (negative).  ``variant`` defaults to ``variant_for(x.dtype)``."""
    _check(x, dt, b, c, a)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"kernel H runs on CUDA tensors, not {dev} "
                         "(ops.ssd_intra_chunk takes CPU tensors)")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x, b, c must share float32 or bfloat16, got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"dt and a must be float32, got {dt.dtype}, "
                        f"{a.dtype}")
    bs, nc, q, h, p = x.shape
    n = b.shape[-1]
    if not 1 <= q <= MAX_CHUNK:
        raise ValueError(f"chunk length {q} is not in [1, {MAX_CHUNK}]")
    if p not in HEAD_DIMS:
        raise ValueError(f"head_dim {p} is not one of {HEAD_DIMS}")
    if n not in STATE_DIMS:
        raise ValueError(f"d_state {n} is not one of {STATE_DIMS}")
    variant = variant_for(x.dtype) if variant is None else variant
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if variant == "wgmma" and x.dtype != torch.bfloat16:
        raise TypeError(f"the wgmma variant takes bfloat16, got {x.dtype}")
    if variant == "cuda_cores" and bs * nc > 65535:
        raise ValueError(f"batch x chunks {bs * nc} above 65535")
    for name, t in (("x", x), ("dt", dt), ("b", b), ("c", c), ("a", a)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if variant == "wgmma" and name in "xbc" and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             "(TMA)")
    out = torch.empty(x.shape, dtype=torch.float32, device=dev)
    launch(kernel("ssd_intra_chunk", "ssd_intra_chunk", *[PTR] * 6,
                  *[I64] * 5, I32, I32, PTR),
           dev, x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
           a.data_ptr(), out.data_ptr(), bs * nc, q, h, p, n,
           _DTYPES[x.dtype], VARIANTS.index(variant), variant=variant)
    return out
