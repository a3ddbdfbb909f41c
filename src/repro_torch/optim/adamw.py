"""AdamW with dtype-configurable state (bf16 moments for memory-tight
configs), global-norm clipping and a cosine schedule.

Counterpart of ``repro/optim/adamw.py``: plain functions over the
parameter tree (an ``LM`` is taken as its ``param_tree``), in the JAX
package's arithmetic order, each leaf's update computed in float32 and
cast back to its dtype.  Not ``torch.optim.AdamW``, whose decay and
rounding differ.  Where the JAX package returns new trees, the port
updates the parameters and the moments in place (the full-width state
would not fit twice) and returns them, so a call reads the same.  The
step, the learning rate and the norm stay 0-d tensors on the parameters'
device: the update asks the host nothing.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core.tree import as_tree, tree_leaves, tree_map
from ..models.params import torch_dtype


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"    # "bfloat16" for memory-tight configs
    warmup_steps: int = 100
    total_steps: int = 10_000


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine to 0 at
    ``total_steps``; float32 of ``step`` (a number or a tensor)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    return cfg.lr * warm * 0.5 * (1 + torch.cos(math.pi * t))


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """Zero moments in ``cfg.state_dtype`` beside each parameter, and the
    step count (int32, 0)."""
    tree = as_tree(params)
    dt = torch_dtype(cfg.state_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    device = tree_leaves(tree)[0].device
    return {"mu": tree_map(zeros, tree), "nu": tree_map(zeros, tree),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """The float32 norm of every leaf together."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig):
    """One AdamW step over ``params`` (updated in place) with ``grads``
    (a tree of the same structure; a missing gradient counts as 0).
    Returns (params, new state, {"grad_norm", "lr"})."""
    tree = as_tree(params)
    step = state["step"] + 1
    gnorm = global_norm([g for g in tree_leaves(grads) if g is not None])
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    stepf = step.float()
    lr = cosine_schedule(cfg, stepf)
    sdt = torch_dtype(cfg.state_dtype)
    bc1 = 1 - cfg.b1 ** stepf
    bc2 = 1 - cfg.b2 ** stepf

    def upd(p, g, mu, nu):
        if g is None:
            g = torch.zeros_like(p)
        g = g.float() * scale
        mu1 = cfg.b1 * mu.float() + (1 - cfg.b1) * g
        nu1 = cfg.b2 * nu.float() + (1 - cfg.b2) * g * g
        mhat = mu1 / bc1
        nhat = nu1 / bc2
        pf = p.float()
        delta = mhat / (torch.sqrt(nhat) + cfg.eps) + cfg.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))
        mu.copy_(mu1.to(sdt))
        nu.copy_(nu1.to(sdt))

    tree_map(upd, tree, grads, state["mu"], state["nu"])
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
