"""Shared primitive layers: RMSNorm, RoPE, SwiGLU MLP, embeddings.

Counterpart of ``repro/layers/core.py``: plain functions over parameter
mappings (an ``nn.Module`` of the port's ``Params`` or a dict), named as
in the JAX package.  Norm math in float32, outputs cast back to the
input's dtype.  ``shard`` annotates activations where the JAX package
does (the identity without a mesh).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.sharding import is_dtensor, shard
from ..models.params import ParamSpec


# -- RMSNorm ----------------------------------------------------------------

def rmsnorm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), (None,), init="ones", dtype="float32")


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight).to(x.dtype)


# -- RoPE --------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int.  Half-split rotation: the
    first and second halves of D are the pairs (``jnp.split(x, 2, -1)``),
    not interleaved."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # (D/2,)
    angles = positions[..., None].float() * freqs             # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- SwiGLU MLP --------------------------------------------------------------

def mlp_specs(d: int, f: int) -> dict:
    return {
        "wi_gate": ParamSpec((d, f), ("fsdp", "mlp")),
        "wi_up": ParamSpec((d, f), ("fsdp", "mlp")),
        "wo": ParamSpec((f, d), ("mlp", "fsdp")),
    }


def gather_seq(x: torch.Tensor) -> torch.Tensor:
    """x (B, S, ...) with its sequence whole on every rank, before a
    matmul that flattens (B, S): where the output's own axes take the
    model axis ("mlp", "vocab"), GSPMD gathers the sequence there
    implicitly; DTensor (torch 2.11) will not flatten two split dims."""
    return shard(x, "batch", *(None,) * (x.dim() - 1))


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    x = gather_seq(x)
    gate = x @ params["wi_gate"]
    up = x @ params["wi_up"]
    h = F.silu(gate.float()).to(x.dtype) * up
    h = shard(h, "batch", "seq", "mlp")
    return h @ params["wo"]


# -- Embedding / logits ------------------------------------------------------

def embed_specs(cfg) -> dict:
    pv, d = cfg.padded_vocab, cfg.d_model
    out = {"embedding": ParamSpec((pv, d), ("vocab", "fsdp"), scale=1.0)}
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamSpec((d, pv), ("fsdp", "vocab"))
    return out


def embed(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    w = params["embedding"].to(dtype)
    if is_dtensor(tokens) and any(p.is_shard() for p in tokens.placements):
        # The lookup's backward on split tokens: DTensor's rule for
        # ``index_put`` breaks there in torch 2.11; ``embedding``'s holds.
        h = F.embedding(tokens, w)
    else:
        h = w[tokens]
    return shard(h, "batch", "seq", None)


def logits_fn(params, h: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Logits over the padded vocabulary; the padding is masked with -1e9
    (in the logits' dtype) so it never wins a softmax or an argmax."""
    if "lm_head" in params:
        logits = h @ params["lm_head"]
    else:
        logits = h @ params["embedding"].t()
    logits = shard(logits, "batch", "seq", "vocab")
    pv = logits.shape[-1]
    if pv > vocab_size:
        if is_dtensor(logits):
            # No sharding rule fills a slice of a DTensor in place.
            pad = torch.arange(pv, device=logits.device) >= vocab_size
            return logits.masked_fill(pad, -1e9)
        logits[..., vocab_size:] = -1e9
    return logits
