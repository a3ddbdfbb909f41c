"""Mamba2 block via SSD (state-space duality), chunked.

Counterpart of ``repro/layers/ssd.py``.  The chunked SSD algorithm (Dao
& Gu, arXiv:2405.21060) splits the sequence into chunks of length Q:

  intra-chunk (quadratic):      Y_intra = (L o (C B^T)) diag(dt) X
  inter-chunk (linear):         h_{c+1} = decay_c h_c + S_c,  Y_inter = C h

The intra-chunk term is kernel H (``kernels/ssd``) on a CUDA tensor and
its plain version on a CPU tensor; the inter-chunk recurrence is a loop
over chunks in torch (the JAX package's ``lax.scan``).  Decode is the O(1)
recurrent form: h = a h + dt x B^T; y = C h.

Layout: x (B, L, H, P); state (B, H, P, N).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.sharding import (check_placements, elementwise,
                                    is_dtensor, shard)
from ..kernels.ssd.ops import ssd_intra_chunk
from ..models.params import ParamSpec
from .core import rmsnorm, rmsnorm_spec


def ssd_specs(cfg) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    nh = d_in // s.head_dim
    return {
        "in_x": ParamSpec((d, d_in), ("fsdp", "mlp")),
        "in_z": ParamSpec((d, d_in), ("fsdp", "mlp")),
        "in_b": ParamSpec((d, s.d_state), ("fsdp", "ssm_state")),
        "in_c": ParamSpec((d, s.d_state), ("fsdp", "ssm_state")),
        "in_dt": ParamSpec((d, nh), ("fsdp", "ssm_heads")),
        "conv_x": ParamSpec((s.conv_kernel, d_in), ("conv", "mlp"),
                            scale=0.5),
        "conv_b": ParamSpec((s.conv_kernel, s.d_state), ("conv", None),
                            scale=0.5),
        "conv_c": ParamSpec((s.conv_kernel, s.d_state), ("conv", None),
                            scale=0.5),
        "A_log": ParamSpec((nh,), ("ssm_heads",), init="zeros",
                           dtype="float32"),
        "D": ParamSpec((nh,), ("ssm_heads",), init="ones", dtype="float32"),
        "dt_bias": ParamSpec((nh,), ("ssm_heads",), init="zeros",
                             dtype="float32"),
        "norm": rmsnorm_spec(d_in),
        "out": ParamSpec((d_in, d), ("mlp", "fsdp")),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv.  x: (B, L, D); w: (K, D).

    With ``state`` (B, K-1, D) performs a streaming conv (decode).  Returns
    the activated output and the new state (the last K-1 inputs, a copy).
    """
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    new_state = xp[:, xp.shape[1] - (k - 1):].clone()
    return F.silu(out.float()).to(x.dtype), new_state


def _segsum(a):
    """Stable segment-sum: S[i, j] = sum_{j < k <= i} a[k] (lower tri)."""
    n = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    s = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=a.device))
    return torch.where(mask, s, -torch.inf)


def _ssd_sharded(x, dt, A, B, C, chunk: int):
    """``ssd_chunked`` of DTensors through ``local_map``: the scan is
    independent per sequence and per head, so each rank scans its own
    batch rows and heads, kernel H included, on plain local tensors.  x
    may be split on its batch (dim 0) and heads (dim 2), any other
    placement raises; dt, A, B and C follow x (B and C, which have no
    heads, are replicated where the heads are split, and their gradient
    there is a partial sum, as is A's over a batch split)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    check_placements("ssd_chunked x", x, (0, 2))
    mesh = x.device_mesh
    xp = tuple(x.placements)
    bp = tuple(p if p == Shard(0) else Replicate() for p in xp)
    bgrad = tuple(Partial() if p == Shard(2) else q for p, q in zip(xp, bp))
    ap = tuple(Shard(0) if p == Shard(2) else Replicate() for p in xp)
    agrad = tuple(Partial() if p == Shard(0) else q for p, q in zip(xp, ap))
    sp = tuple(p if p == Shard(0) else (Shard(1) if p == Shard(2)
                                        else Replicate()) for p in xp)
    dt, A = dt.redistribute(mesh, xp), A.redistribute(mesh, ap)
    B, C = B.redistribute(mesh, bp), C.redistribute(mesh, bp)
    return local_map(
        lambda *t: ssd_chunked(*t, chunk), out_placements=(xp, sp),
        in_placements=(xp, xp, ap, bp, bp),
        in_grad_placements=(xp, xp, agrad, bgrad, bgrad),
        device_mesh=mesh)(x, dt, A, B, C)


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """Chunked SSD scan.

    x: (b, l, h, p); dt: (b, l, h) (post-softplus, float32); A: (h,)
    negative; B, C: (b, l, n).  Returns y: (b, l, h, p) in x's dtype and
    the final state (b, h, p, n) float32.  On DTensors, ``_ssd_sharded``.
    """
    if is_dtensor(x):
        return _ssd_sharded(x, dt, A, B, C, chunk)
    b, l0, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, l0)
    pad = (-l0) % q
    if pad:
        # Zero-pad the tail: dt = 0 makes padded steps identity transitions
        # (decay exp(0) = 1, contribution dt B x = 0), so the state is exact.
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = (l0 + pad) // q
    xc = x.reshape(b, nc, q, h, p).contiguous()
    dtc = dt.reshape(b, nc, q, h).float().contiguous()
    Bc = B.reshape(b, nc, q, n).contiguous()
    Cc = C.reshape(b, nc, q, n).contiguous()
    da = dtc * A                                          # (b,nc,q,h)

    y_intra = ssd_intra_chunk(xc, dtc, Bc, Cc, A.float().contiguous())

    # Chunk states and the inter-chunk recurrence.
    Bf, Cf, xf = Bc.float(), Cc.float(), xc.float()
    suffix_incl = torch.flip(torch.cumsum(torch.flip(da, [2]), dim=2), [2])
    decay_to_end = torch.exp(suffix_incl - da)            # exclusive suffix
    w = (dtc * decay_to_end)[..., None] * xf              # (b,nc,q,h,p)
    S = torch.einsum("bcqn,bcqhp->bchpn", Bf, w)          # per-chunk state
    chunk_decay = torch.exp(da.sum(dim=2))                # (b,nc,h)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + S[:, c]
    h_prev = torch.stack(h_prev, dim=1)                   # (b,nc,h,p,n)

    decay_from_start = torch.exp(torch.cumsum(da, dim=2))  # (b,nc,q,h)
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cf, h_prev) \
        * decay_from_start[..., None]
    y = (y_intra + y_inter).reshape(b, nc * q, h, p)[:, :l0]
    return y.to(x.dtype), state


def ssd_decode_step(x, dt, A, B, C, h):
    """One-token recurrence.  x: (b, h, p); B, C: (b, n); h: (b,h,p,n)."""
    dtf = dt.float()
    da = torch.exp(dtf * A)                               # (b, h)
    h = h * da[..., None, None] + (dtf[..., None] * x.float())[..., None] \
        * B.float()[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h, C.float())
    return y.to(x.dtype), h


def mamba_block(params, cfg, x: torch.Tensor, state: dict | None = None):
    """Full Mamba2 block.  x: (B, L, d).

    ``state`` (decode): {"ssm": (B,H,P,N), "conv_x": (B,K-1,Din),
    "conv_b": (B,K-1,N), "conv_c": (B,K-1,N)}.  Returns (y, new_state).
    """
    s = cfg.ssm
    bsz, l, d = x.shape
    d_in = s.expand * d
    nh = d_in // s.head_dim
    decode = state is not None

    z = x @ params["in_z"]
    xs = x @ params["in_x"]
    Braw = x @ params["in_b"]
    Craw = x @ params["in_c"]
    dt = elementwise(F.softplus,
                     (x @ params["in_dt"]).float() + params["dt_bias"])

    xs, cx = _causal_conv(xs, params["conv_x"],
                          state["conv_x"] if decode else None)
    Bv, cb = _causal_conv(Braw, params["conv_b"],
                          state["conv_b"] if decode else None)
    Cv, cc = _causal_conv(Craw, params["conv_c"],
                          state["conv_c"] if decode else None)
    xs = shard(xs, "batch", "seq", "mlp")
    A = -torch.exp(params["A_log"])                       # (h,) negative
    xh = xs.reshape(bsz, l, nh, s.head_dim)
    xh = shard(xh, "batch", "seq", "ssm_heads", None)

    if decode:
        y1, h1 = ssd_decode_step(xh[:, 0], dt[:, 0], A, Bv[:, 0], Cv[:, 0],
                                 state["ssm"])
        y = y1[:, None]
    else:
        y, h1 = ssd_chunked(xh, dt, A, Bv, Cv, s.chunk)
    new_state = {"ssm": h1, "conv_x": cx, "conv_b": cb, "conv_c": cc}
    y = y + xh * params["D"][:, None].to(x.dtype)
    y = y.reshape(bsz, l, d_in)
    y = rmsnorm(y * F.silu(z.float()).to(x.dtype), params["norm"],
                cfg.rms_eps)
    return y @ params["out"], new_state
