"""GQA attention: qk-norm / qkv-bias variants, causal, cross, and decode.

Counterpart of ``repro/layers/attention.py``.  ``_sdpa`` is the JAX
package's single-shot math.  ``_sdpa_chunked`` is where the JAX package
tiles prefill attention over query blocks; the port computes the same
function with kernel G (``kernels/flash_attn``) on a CUDA tensor, at any
sequence length, causal or not, and with ``_sdpa`` on a CPU tensor.  The
encoder's self-attention (``causal=False``) and the decoder's cross
attention over the encoder's keys take the same route.  Decode (one query
against a length-masked cache, or against the encoder's keys) stays plain
torch, as the JAX package computes it outside Pallas.
"""
from __future__ import annotations

import math

import torch

from ..distributed.sharding import is_dtensor, local_range, shard
from ..kernels.flash_attn.ops import flash_attention
from ..models.params import ParamSpec
from .core import apply_rope, rmsnorm, rmsnorm_spec

NEG_INF = -1e9


def attn_specs(cfg, *, cross: bool = False) -> dict:
    """Projections of a self-attention block, or of a cross-attention
    block (``cross``: no qkv bias, no qk-norm)."""
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    out = {
        "wq": ParamSpec((d, h, hd), ("fsdp", "heads", "head_dim")),
        "wk": ParamSpec((d, kv, hd), ("fsdp", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kv, hd), ("fsdp", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "fsdp")),
    }
    if cfg.qkv_bias and not cross:
        out["bq"] = ParamSpec((h, hd), ("heads", "head_dim"), init="zeros")
        out["bk"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"),
                              init="zeros")
        out["bv"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"),
                              init="zeros")
    if cfg.qk_norm and not cross:
        out["q_norm"] = rmsnorm_spec(hd)
        out["k_norm"] = rmsnorm_spec(hd)
    return out


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one contiguous matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def _project_qkv(params, cfg, x, positions, *, rope: bool = True):
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if "q_norm" in params:
        q = rmsnorm(q, params["q_norm"], cfg.rms_eps)
        k = rmsnorm(k, params["k_norm"], cfg.rms_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = shard(q, "batch", None, "heads", "head_dim")
    k = shard(k, "batch", None, "kv_heads", "head_dim")
    v = shard(v, "batch", None, "kv_heads", "head_dim")
    return q, k, v


def _heads_like(q, k):
    """The DTensor q with its heads replicated on every mesh dim where k's
    heads are not split the same way (the grouped view of q cannot split
    kv heads that the mesh dim does not divide).  One decode row's q is
    small."""
    from torch.distributed.tensor import Replicate, Shard

    want = tuple(Replicate() if p == Shard(2) and pk != Shard(2) else p
                 for p, pk in zip(q.placements, k.placements))
    return q if want == tuple(q.placements) else \
        q.redistribute(q.device_mesh, want)


def _sdpa(q, k, v, mask, num_kv: int):
    """Grouped scaled-dot-product attention (single shot).

    q: (B, Sq, H, D); k/v: (B, Sk, KV, D); mask: bool, broadcastable to
    (B, KV, G, Sq, Sk), or None.
    """
    b, sq, h, d = q.shape
    g = h // num_kv
    if is_dtensor(q):
        q = _heads_like(q, k)
    qg = q.reshape(b, sq, num_kv, g, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    scores = scores / math.sqrt(d)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, sq, h, d)


def _sdpa_chunked(q, k, v, num_kv: int, *, causal: bool):
    """Prefill attention: kernel G on a CUDA tensor, ``_sdpa`` with the
    causal mask (or none) on a CPU tensor.  (The JAX package splits the
    queries into blocks of 128 so its scores fit memory; the split is not
    part of the function, and kernel G keeps the scores out of memory
    itself.)"""
    return flash_attention(q, k.contiguous(), v.contiguous(),
                           num_kv_heads=num_kv, causal=causal)


def attention(params, cfg, x: torch.Tensor, positions: torch.Tensor,
              *, causal: bool = True):
    """Full-sequence attention (train / prefill).  Returns (out, (k, v))."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = _sdpa_chunked(q, k, v, cfg.num_kv_heads, causal=causal)
    out = shard(out, "batch", None, "heads", "head_dim")
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), (k, v)


def cross_attention(params, cfg, x: torch.Tensor,
                    kv_cache: tuple[torch.Tensor, torch.Tensor]):
    """Decoder-side cross attention over precomputed encoder K/V, with no
    mask and no RoPE.  A prompt's queries take kernel G (``causal=False``)
    on a CUDA tensor; one query row (a decode step) stays plain ``_sdpa``,
    as ``decode_attention`` does."""
    q = _proj(x, params["wq"])
    q = shard(q, "batch", None, "heads", "head_dim")
    k, v = kv_cache
    if q.shape[1] == 1:
        out = _sdpa(q, k, v, None, cfg.num_kv_heads)
    else:
        out = _sdpa_chunked(q, k, v, cfg.num_kv_heads, causal=False)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


def cross_kv(params, enc_out: torch.Tensor):
    """The encoder output's keys and values for cross attention:
    (B, F, KV, D) each, with no bias and no RoPE."""
    k = _proj(enc_out, params["wk"])
    v = _proj(enc_out, params["wv"])
    return (shard(k, "batch", "seq", "kv_heads", "head_dim"),
            shard(v, "batch", "seq", "kv_heads", "head_dim"))


def write_seq(dst: torch.Tensor, src: torch.Tensor, start: int) -> None:
    """``dst[:, start:start + S] = src`` in place, S = src.shape[1].  On
    DTensors each rank writes the positions of its own shard of ``dst``
    (``src`` is first given ``dst``'s placements, replicated along the
    sequence), as no sharding rule writes a slice of a DTensor."""
    if not is_dtensor(dst):
        dst[:, start:start + src.shape[1]] = src
        return
    from torch.distributed.tensor import Replicate, Shard

    want = tuple(Replicate() if p == Shard(1) else p
                 for p in dst.placements)
    src = src.redistribute(dst.device_mesh, want).to_local()
    lo, hi = local_range(dst, 1)
    a, b = max(start, lo), min(start + src.shape[1], hi)
    if a < b:
        dst.to_local()[:, a - lo:b - lo] = src[:, a - start:b - start]


def decode_attention(params, cfg, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int):
    """One-token attention against a KV cache.

    x: (B, 1, d); k_cache/v_cache: (B, S_max, KV, D).  The new key and
    value are written into the caches in place at ``cache_len`` (the JAX
    package returns updated copies).  Returns (out, k_cache, v_cache).
    """
    b, smax = k_cache.shape[0], k_cache.shape[1]
    positions = torch.full((b, 1), cache_len, dtype=torch.int32,
                           device=x.device)
    q, k_new, v_new = _project_qkv(params, cfg, x, positions)
    write_seq(k_cache, k_new.to(k_cache.dtype), cache_len)
    write_seq(v_cache, v_new.to(v_cache.dtype), cache_len)
    k_cache = shard(k_cache, "batch", "cache_seq", "kv_heads", "head_dim")
    v_cache = shard(v_cache, "batch", "cache_seq", "kv_heads", "head_dim")
    mask = torch.arange(smax, device=x.device) <= cache_len
    out = _sdpa(q, k_cache, v_cache, mask, cfg.num_kv_heads)
    return (torch.einsum("bshk,hkd->bsd", out, params["wo"]),
            k_cache, v_cache)
