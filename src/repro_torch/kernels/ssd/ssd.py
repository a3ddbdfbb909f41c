"""Kernel H: the Mamba2 SSD intra-chunk term.

Counterpart of ``repro/kernels/ssd/ssd.py`` (``ssd_intra_chunk_pallas``).
Per (batch, chunk, head):

    Y = (L o C B^T) diag(dt) X,   L[i, j] = exp(sum_{j<k<=i} dt_k A)

zero above the diagonal.  On CUDA tensors ``ssd_intra_chunk`` launches
``csrc/ssd_intra_chunk.cu`` at any chunk length up to 256; on CPU tensors
it runs ``ssd_intra_chunk_plain``, the JAX oracle ``ssd_intra_chunk_ref``
(the einsums of ``ssd_chunked``).  There is no fallback between the two.

Output dtype: float32 always, what ``ssd_chunked`` needs (it adds the
inter-chunk term before it casts).  The Pallas kernel and its oracle
return x's dtype; the port's tests compare against them cast to float32.
"""
from __future__ import annotations

import ctypes

import torch

HEAD_DIMS = (16, 32, 64)
STATE_DIMS = (16, 64, 128)
MAX_CHUNK = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches since the last reset


def ssd_intra_chunk_plain(x, dt, b, c, a) -> torch.Tensor:
    """Plain version, float32: x (B, NC, Q, H, P); dt (B, NC, Q, H);
    b, c (B, NC, Q, N); a (H,)."""
    # Imported here: repro_torch.layers.ssd imports this module.
    from ...layers.ssd import _segsum

    dtf = dt.float()
    da = dtf * a.float()
    l_mat = torch.exp(_segsum(da.permute(0, 1, 3, 2)))      # (B,NC,H,Q,Q)
    scores = torch.einsum("bcqn,bckn->bcqk", c.float(), b.float())
    m = scores[:, :, None] * l_mat
    return torch.einsum("bchqk,bckh,bckhp->bcqhp", m, dtf, x.float())


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
                    c: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Y_intra (B, NC, Q, H, P) float32 of x (B, NC, Q, H, P); dt
    (B, NC, Q, H) float32; b, c (B, NC, Q, N) of x's dtype; a (H,)
    float32 (negative)."""
    _check(x, dt, b, c, a)
    dev = x.device
    if dev.type == "cpu":
        return ssd_intra_chunk_plain(x, dt, b, c, a)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
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
    if bs * nc > 65535:
        raise ValueError(f"batch x chunks {bs * nc} above 65535")
    for name, t in (("x", x), ("dt", dt), ("b", b), ("c", c), ("a", a)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    from .._build import check, load

    fn = load("ssd_intra_chunk").ssd_intra_chunk
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 5 + \
        [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(x.shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
                 a.data_ptr(), out.data_ptr(), bs * nc, q, h, p, n,
                 _DTYPES[x.dtype], stream)
    check(err, "ssd_intra_chunk")
    global launches
    launches += 1
    return out
