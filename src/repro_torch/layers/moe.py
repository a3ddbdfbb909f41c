"""Mixture-of-Experts FFN with two dispatch engines.

Counterpart of ``repro/layers/moe.py``; the JAX package's ``shard``
annotations are the identity on one card and are dropped.

1. ``dense``  -- one-hot dispatch: tokens in groups of ``_group_len``,
   each group with its own expert capacity; dispatch and combine are
   einsums over (G, T, E, C) one-hot tensors.
2. ``sorted`` -- the paper's radix-partition dispatch: routing tokens to
   experts is partitioning steps n1..n3 on expert ids.  The expert id is
   the partition number (n1), ``partition_n2`` gives the expert loads and
   their scan-allocated offsets (n2; kernel E on a CUDA tensor), and a
   stable scatter fills each expert's capacity buffer (n3), overflow
   dropped like the allocator's spill.

Both compute the same function wherever neither drops a (token, slot)
pair.  Top-k keeps ``jax.lax.top_k``'s order (equal probabilities: lower
expert first), which sets the capacity priority and the aux loss's top-1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.partition import partition_n2
from ..models.params import ParamSpec
from .core import mlp, mlp_specs


def moe_specs(cfg) -> dict:
    m = cfg.moe
    d = cfg.d_model
    out = {
        "router": ParamSpec((d, m.num_experts), ("fsdp", None)),
        "wi_gate": ParamSpec((m.num_experts, d, m.d_ff),
                             ("experts", "fsdp", "expert_mlp")),
        "wi_up": ParamSpec((m.num_experts, d, m.d_ff),
                           ("experts", "fsdp", "expert_mlp")),
        "wo": ParamSpec((m.num_experts, m.d_ff, d),
                        ("experts", "expert_mlp", "fsdp")),
    }
    if m.shared_d_ff:
        out["shared"] = mlp_specs(d, m.shared_d_ff)
    return out


def _capacity(tokens_per_group: int, m) -> int:
    c = -(-int(tokens_per_group * m.top_k * m.capacity_factor)
          // m.num_experts)
    if c >= 48:
        # Large capacities round to 64, as the JAX package rounds them
        # for its 16-way model axis.
        return ((c + 63) // 64) * 64
    return max(4, ((c + 3) // 4) * 4)


def _route(params, m, xg: torch.Tensor):
    """Router: top-k experts + normalized weights per token.

    xg: (G, T, d) grouped tokens.  Returns (expert_idx (G, T, k) int32,
    weights (G, T, k) in xg's dtype, router_probs (G, T, E) float32).
    The logits are rounded to xg's dtype before the float32 softmax, as
    the JAX package computes them, so ties are common in bfloat16: a
    stable descending sort takes them lowest expert first, as
    ``jax.lax.top_k`` does (``torch.topk`` does not)."""
    logits = (xg @ params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    wk = top.values[..., :m.top_k]
    idx = top.indices[..., :m.top_k].to(torch.int32)
    wk = wk / torch.clamp(wk.sum(-1, keepdim=True), min=1e-9)
    return idx, wk.to(xg.dtype), probs


def _experts_ffn(params, expert_in: torch.Tensor) -> torch.Tensor:
    """expert_in: (G, E, C, d) -> (G, E, C, d)."""
    gate = torch.einsum("gecd,edf->gecf", expert_in, params["wi_gate"])
    up = torch.einsum("gecd,edf->gecf", expert_in, params["wi_up"])
    h = F.silu(gate.float()).to(expert_in.dtype) * up
    return torch.einsum("gecf,efd->gecd", h, params["wo"])


def _aux_loss(probs: torch.Tensor, expert_idx: torch.Tensor,
              num_experts: int) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum_e f_e * P_e (float32)."""
    f = F.one_hot(expert_idx[..., 0].long(), num_experts).float() \
        .mean(dim=(0, 1))
    p = probs.mean(dim=(0, 1))
    return num_experts * (f * p).sum()


def _group_len(n: int, pref: int) -> int:
    """Largest divisor of n that is <= pref (dispatch group length)."""
    for t in range(min(pref, n), 0, -1):
        if n % t == 0:
            return t
    return 1


def moe_dense(params, cfg, x: torch.Tensor):
    """One-hot dispatch.  x: (B, S, d) -> (B, S, d), aux loss."""
    m = cfg.moe
    b, s, d = x.shape
    t = _group_len(b * s, m.group_size)
    g = (b * s) // t
    xg = x.reshape(g, t, d)
    idx, wk, probs = _route(params, m, xg)
    cap = _capacity(t, m)
    e = m.num_experts
    # Position of each (token, slot) within its expert's capacity buffer:
    # its rank among the group's pairs routed there, slot-major.
    oh = F.one_hot(idx.long(), e).to(torch.int32)          # (G,T,K,E)
    oh_flat = oh.transpose(1, 2).reshape(g, m.top_k * t, e)
    pos_flat = torch.cumsum(oh_flat, dim=1, dtype=torch.int32) - oh_flat
    pos = pos_flat.reshape(g, m.top_k, t, e).transpose(1, 2)
    pos = (pos * oh).sum(-1)                                # (G,T,K)
    keep = pos < cap
    # Dispatch/combine tensors (G,T,E,C); a dropped pair's row is zero,
    # as jax.nn.one_hot gives for a position past the capacity.
    slots = torch.arange(cap, device=x.device)
    pos_oh = ((pos[..., None] == slots) & keep[..., None]).to(x.dtype)
    oh_x = oh.to(x.dtype)
    disp = torch.einsum("gtke,gtkc->gtec", oh_x, pos_oh)
    comb = torch.einsum("gtke,gtkc->gtec", oh_x, pos_oh * wk[..., None])
    expert_in = torch.einsum("gtec,gtd->gecd", disp, xg)
    expert_out = _experts_ffn(params, expert_in)
    out = torch.einsum("gtec,gecd->gtd", comb, expert_out)
    if "shared" in params:
        out = out + mlp(params["shared"], xg)
    return out.reshape(b, s, d), _aux_loss(probs, idx, e)


def moe_sorted(params, cfg, x: torch.Tensor):
    """Radix-partition dispatch (the paper's n1..n3 on expert ids)."""
    m = cfg.moe
    b, s, d = x.shape
    n = b * s
    k = m.top_k
    xf = x.reshape(n, d)
    idx, wk, probs = _route(params, m, xf[None])          # treat as 1 group
    idx, wk = idx[0], wk[0]                               # (N,K)
    e = m.num_experts
    cap = _capacity(n, m)
    # n1: partition number = expert id, one entry per (token, slot) --
    # slot-major order so capacity drops match moe_dense's priority.
    pid = idx.t().reshape(-1)                             # (K*N,) int32
    tok = torch.arange(n, dtype=torch.int32, device=x.device).repeat(k)
    w = wk.t().reshape(-1)
    # n2: expert headers -- histogram + scan allocation.
    starts, _ = partition_n2(pid, e)
    # n3: scatter <token, weight> into the expert's capacity buffer.
    order = torch.sort(pid, stable=True).indices
    pid_o = pid[order]
    rank = torch.arange(n * k, dtype=torch.int32,
                        device=x.device) - starts[pid_o]
    keep = rank < cap
    slot = torch.where(keep, pid_o * cap + rank, e * cap)  # spill -> drop
    # Every dropped pair writes the spill slot e * cap, which is cut off.
    buf_tok = torch.zeros(e * cap + 1, dtype=torch.int32, device=x.device)
    buf_tok[slot] = tok[order]
    buf_valid = torch.zeros(e * cap + 1, dtype=torch.bool, device=x.device)
    buf_valid[slot] = keep
    expert_in = torch.where(buf_valid[:e * cap, None],
                            xf[buf_tok[:e * cap]], 0).reshape(1, e, cap, d)
    expert_out = _experts_ffn(params, expert_in).reshape(e * cap, d)
    # combine: gather each kept (token, slot)'s output back, weighted.
    contrib = torch.where(keep[:, None],
                          expert_out[slot.clamp(0, e * cap - 1)], 0)
    contrib = contrib * w[order][:, None]
    # The JAX package's scatter-add sums a token's contributions in the
    # order of ``order`` (ascending expert), rounding each add to x's
    # dtype; the same sum here, as k gathers in that order.  (index_add_
    # on a card adds in an order that changes from run to run.)
    at = torch.empty_like(order)
    at[order] = torch.arange(n * k, device=x.device)
    at = torch.sort(at.view(k, n).t(), dim=1).values     # (N,K) ascending
    out = torch.zeros(n, d, dtype=x.dtype, device=x.device)
    for j in range(k):
        out = out + contrib[at[:, j]]
    if "shared" in params:
        out = out + mlp(params["shared"], xf[None]).reshape(n, d)
    return out.reshape(b, s, d), _aux_loss(probs, idx[None], e)


def moe(params, cfg, x: torch.Tensor):
    if cfg.moe_impl == "sorted":
        return moe_sorted(params, cfg, x)
    return moe_dense(params, cfg, x)
