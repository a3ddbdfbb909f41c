"""Train and eval steps: loss, gradient and AdamW, with optional gradient
accumulation and simulated int8 gradient compression.

Counterpart of ``repro/train/step.py``.  ``make_train_step(cfg, opt)``
returns ``train_step(params, opt_state, batch) -> (params, opt_state,
metrics)`` as the JAX package's does; ``params`` is the port's ``LM``,
which the step makes trainable and updates in place.  The gradient is
autograd's through the forward (kernels G and H run inside their
``torch.autograd.Function``s, each unit rematerialised as ``cfg.remat``
says).  The JAX package's mesh and sharding rules are not ported, so the
factories take none; nor are its dry-run's ``batch_specs`` and
``abstract_batch``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from ..configs.base import ModelConfig
from ..core.tree import param_tree, tree_leaves, tree_map
from ..layers.core import logits_fn
from ..models import transformer as tfm
from ..optim.adamw import AdamWConfig, adamw_update

AUX_LOSS_WEIGHT = 0.01
XENT_CHUNK = 8  # sequence chunks for the blockwise loss
METRICS = ("loss", "aux_loss", "tokens")


def chunked_xent(embed_params, h, labels, vocab_size: int):
    """Blockwise softmax cross-entropy: float32 logits exist one sequence
    chunk at a time ((B, S/k, V) instead of (B, S, V)), each chunk
    recomputed in the backward.  Labels below 0 are masked out.  Returns
    (sum of the token losses, number of tokens counted)."""
    b, s, _ = h.shape
    k = XENT_CHUNK if s % XENT_CHUNK == 0 else 1

    def one(hc, lc):
        logits = logits_fn(embed_params, hc, vocab_size).float()
        # log_softmax and the label's term in one op, whose backward
        # writes each row once (a gather's backward would add with
        # atomics on a card, in an order that changes from run to run).
        nll = F.cross_entropy(logits.flatten(0, -2),
                              lc.clamp(min=0).long().flatten(),
                              reduction="none").view(lc.shape)
        mask = (lc >= 0).float()
        return (nll * mask).sum(), mask.sum()

    if torch.is_grad_enabled():
        body = one
        one = lambda hc, lc: ckpt.checkpoint(body, hc, lc,
                                             use_reentrant=False)
    parts = [one(hc, lc) for hc, lc in zip(h.chunk(k, dim=1),
                                           labels.chunk(k, dim=1))]
    return (torch.stack([p[0] for p in parts]).sum(),
            torch.stack([p[1] for p in parts]).sum())


def loss_fn(params, cfg: ModelConfig, batch: dict):
    """(loss + AUX_LOSS_WEIGHT * aux, {"loss", "aux_loss", "tokens"})."""
    h, aux = tfm.forward_hidden(params, cfg, batch["tokens"],
                                batch.get("enc_frames"))
    nll, ntok = chunked_xent(params["embed"], h, batch["labels"],
                             cfg.vocab_size)
    loss = nll / torch.clamp(ntok, min=1.0)
    total = loss + AUX_LOSS_WEIGHT * aux
    return total, {"loss": loss.detach(), "aux_loss": aux.detach(),
                   "tokens": ntok.detach()}


def loss_and_grads(params, cfg: ModelConfig, batch: dict, leaves: list):
    """``loss_fn``'s metrics on ``batch`` and the gradient of each of
    ``leaves`` (None where no path reaches it), in the leaves' dtypes."""
    for p in leaves:
        p.grad = None
    total, metrics = loss_fn(params, cfg, batch)
    total.backward()
    grads = [p.grad for p in leaves]
    for p in leaves:
        p.grad = None
    return metrics, grads


def make_train_step(cfg: ModelConfig, opt: AdamWConfig, *,
                    accum_steps: int = 1, compress_pod_grads: bool = False):
    """The train step, microbatched when ``accum_steps`` > 1: each
    microbatch's gradient is added into float32 buffers, the sum and the
    metrics divided by ``accum_steps``, so AdamW receives float32
    gradients (the parameters' dtype with one microbatch), as in the JAX
    package."""

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        tree = param_tree(params)
        leaves = tree_leaves(tree)
        if accum_steps == 1:
            metrics, grads = loss_and_grads(params, cfg, batch, leaves)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % accum_steps:
                raise ValueError(f"batch {b} does not split into "
                                 f"{accum_steps} microbatches")
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            metrics = dict.fromkeys(METRICS, 0.0)
            for i in range(accum_steps):
                mb = {k: v.chunk(accum_steps)[i] for k, v in batch.items()}
                m, g = loss_and_grads(params, cfg, mb, leaves)
                for acc, gi in zip(grads, g):
                    if gi is not None:
                        acc += gi.float()
                metrics = {k: metrics[k] + m[k] for k in METRICS}
            for g in grads:
                g.div_(accum_steps)
            metrics = {k: v / accum_steps for k, v in metrics.items()}
        by_leaf = dict(zip(map(id, leaves), grads))
        grads = tree_map(lambda p: by_leaf[id(p)], tree)
        if compress_pod_grads:
            from .compress import ef_int8_allreduce_sim
            grads = ef_int8_allreduce_sim(grads)
        params, opt_state, om = adamw_update(params, grads, opt_state, opt)
        metrics.update(om)
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig):
    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, cfg, batch)
        return metrics
    return eval_step
