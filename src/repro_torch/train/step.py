"""Train and eval steps: loss, gradient and AdamW, with optional gradient
accumulation and simulated int8 gradient compression.

Counterpart of ``repro/train/step.py``.  ``make_train_step(cfg, mesh,
rules, opt)`` returns ``train_step(params, opt_state, batch) -> (params,
opt_state, metrics)`` as the JAX package's does; ``params`` is the port's
``LM``, which the step makes trainable and updates in place.  The
gradient is autograd's through the forward (kernels G and H run inside
their ``torch.autograd.Function``s, each unit rematerialised as
``cfg.remat`` says).

``mesh=None, rules=None`` is one device with plain tensors.  With a mesh
(a ``DeviceMesh``, ``launch/mesh.py``) the step distributes the LM's
parameters by ``rules`` (once: they stay DTensors), the AdamW moments
with their parameters' placements (ZeRO: the optimizer shards with the
weights) and each microbatch by ``batch_specs``, and runs under
``shard_ctx``; its metrics come back as plain tensors.
``batch_specs`` and ``abstract_batch`` serve the dry-run.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from ..configs.base import ModelConfig, ShapeSpec
from ..core.tree import param_tree, tree_leaves, tree_map
from ..distributed.sharding import (ShardingRules, Sharding, is_dtensor,
                                    make_sharding, shard_ctx)
from ..layers.core import gather_seq, logits_fn
from ..models import transformer as tfm
from ..models.params import (ParamSpec, abstract, distribute, place,
                             shardings)
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
    h, labels = gather_seq(h), gather_seq(labels)

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


def place_lm(params, cfg: ModelConfig, mesh, rules: ShardingRules):
    """The LM's parameters distributed on ``mesh`` by ``rules`` (in
    place; parameters that are DTensors already stay as they are)."""
    if not any(is_dtensor(p) for p in params.parameters()):
        place(params, tfm.lm_specs(cfg), mesh, rules)
    return params


def place_opt_state(params, opt_state: dict) -> dict:
    """The AdamW moments with the placements of their parameters."""
    tree = param_tree(params)

    def like(m, p):
        if not is_dtensor(p) or is_dtensor(m):
            return m
        return distribute(m, Sharding(p.device_mesh, tuple(p.placements)))
    return dict(opt_state, mu=tree_map(like, opt_state["mu"], tree),
                nu=tree_map(like, opt_state["nu"], tree))


def place_batch(cfg: ModelConfig, batch: dict, mesh,
                rules: ShardingRules) -> dict:
    """Each tensor of ``batch`` (full on every rank) distributed by
    ``batch_specs``' axes."""
    b, s = batch["tokens"].shape
    specs = batch_specs(cfg, ShapeSpec("batch", s, b, "train"))
    return {k: distribute(v, make_sharding(mesh, rules, specs[k].axes,
                                           tuple(v.shape)))
            for k, v in batch.items()}


def _plain(metrics: dict) -> dict:
    return {k: v.full_tensor() if is_dtensor(v) else v
            for k, v in metrics.items()}


def make_train_step(cfg: ModelConfig, mesh, rules: ShardingRules,
                    opt: AdamWConfig, *, accum_steps: int = 1,
                    compress_pod_grads: bool = False):
    """The train step, microbatched when ``accum_steps`` > 1: each
    microbatch's gradient is added into float32 buffers, the sum and the
    metrics divided by ``accum_steps``, so AdamW receives float32
    gradients (the parameters' dtype with one microbatch), as in the JAX
    package.  ``mesh`` and ``rules`` as the module says."""

    def train_step(params, opt_state, batch):
        if mesh is not None:
            place_lm(params, cfg, mesh, rules)
            opt_state = place_opt_state(params, opt_state)
        with shard_ctx(mesh, rules):
            params, opt_state, metrics = _step(params, opt_state, batch)
        return params, opt_state, _plain(metrics)

    def microbatch(batch, i):
        mb = batch if accum_steps == 1 else {
            k: v.chunk(accum_steps)[i] for k, v in batch.items()}
        if mesh is not None and not is_dtensor(mb["tokens"]):
            mb = place_batch(cfg, mb, mesh, rules)
        return mb

    def _step(params, opt_state, batch):
        params.requires_grad_(True)
        tree = param_tree(params)
        leaves = tree_leaves(tree)
        if accum_steps == 1:
            metrics, grads = loss_and_grads(params, cfg, microbatch(batch, 0),
                                            leaves)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % accum_steps:
                raise ValueError(f"batch {b} does not split into "
                                 f"{accum_steps} microbatches")
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in leaves]
            metrics = dict.fromkeys(METRICS, 0.0)
            for i in range(accum_steps):
                m, g = loss_and_grads(params, cfg, microbatch(batch, i),
                                      leaves)
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


def make_eval_step(cfg: ModelConfig, mesh, rules: ShardingRules):
    @torch.no_grad()
    def eval_step(params, batch):
        if mesh is not None:
            place_lm(params, cfg, mesh, rules)
            if not is_dtensor(batch["tokens"]):
                batch = place_batch(cfg, batch, mesh, rules)
        with shard_ctx(mesh, rules):
            _, metrics = loss_fn(params, cfg, batch)
        return _plain(metrics)
    return eval_step


# --------------------------------------------------------------------------
# Batch specs (abstract tensors for the dry-run; see launch/dryrun.py).
# --------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    b, s = shape.global_batch, shape.seq_len
    out = {
        "tokens": ParamSpec((b, s), ("batch", "seq"), dtype="int32"),
        "labels": ParamSpec((b, s), ("batch", "seq"), dtype="int32"),
    }
    if cfg.encoder:
        out["enc_frames"] = ParamSpec(
            (b, cfg.encoder.num_frames, cfg.d_model),
            ("batch", None, None), dtype=cfg.dtype)
    return out


def abstract_batch(cfg: ModelConfig, shape: ShapeSpec, mesh, rules, *,
                   device="meta"):
    """DTensors of local shards with no data (``models.params.abstract``),
    one per ``batch_specs`` entry, on ``mesh`` by ``rules``."""
    specs = batch_specs(cfg, shape)
    return abstract(specs, shardings_tree=shardings(specs, mesh, rules),
                    device=device)
