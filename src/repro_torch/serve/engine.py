"""Serving: prefill / decode step factories and a batched greedy engine.

Counterpart of ``repro/serve/engine.py``.  ``make_prefill_step(cfg,
mesh, rules)`` and ``make_decode_step(cfg, mesh, rules)`` take the JAX
package's arguments: ``mesh=None`` is one device with plain tensors;
with a mesh the step distributes the LM's parameters by ``rules`` (once)
and its tokens by their logical axes, and runs under ``shard_ctx``, so
logits and caches come back as DTensors.  ``abstract_cache`` gives the
dry-run's cache.  The self-attention caches are allocated at ``max_seq``
before the first decode step (``grow_cache``, on the rules' placements
under a mesh), as the JAX engine grows them, and each decode step writes
its key and value into them in place.  An encoder-decoder config's cross
K/V (``ck`` / ``cv``) stay the prefill's own tensors, as the JAX engine
pads only ``k`` and ``v``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig
from ..distributed.sharding import (ShardingRules, current_rules,
                                    is_dtensor, make_sharding, shard,
                                    shard_ctx)
from ..layers.attention import write_seq
from ..models import transformer as tfm
from ..models.params import (abstract, distribute, shardings, torch_dtype,
                             zeros_on)
from ..train.step import place_lm

CACHE_AXES = ("batch", "cache_seq", "kv_heads", "head_dim")


def _place_tokens(tokens, mesh, rules, axes):
    if mesh is None or is_dtensor(tokens):
        return tokens
    return distribute(tokens, make_sharding(mesh, rules, axes,
                                            tuple(tokens.shape)))


def make_prefill_step(cfg: ModelConfig, mesh, rules: ShardingRules):
    def prefill_step(params, batch):
        frames = batch.get("enc_frames")
        if mesh is not None:
            place_lm(params, cfg, mesh, rules)
            if frames is not None:
                frames = _place_tokens(frames, mesh, rules,
                                       ("batch", None, None))
        tokens = _place_tokens(batch["tokens"], mesh, rules,
                               ("batch", "seq"))
        with shard_ctx(mesh, rules):
            return tfm.prefill(params, cfg, tokens, frames)
    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh, rules: ShardingRules):
    def decode_step(params, cache, tokens, cache_len: int):
        if mesh is not None:
            place_lm(params, cfg, mesh, rules)
        tokens = _place_tokens(tokens, mesh, rules, ("batch", None))
        with shard_ctx(mesh, rules):
            logits, new_cache = tfm.decode_step(params, cfg, tokens, cache,
                                                cache_len)
            # The next token from the whole vocabulary on every rank.
            next_tok = torch.argmax(shard(logits, "batch", None),
                                    dim=-1).to(torch.int32)
        return next_tok[:, None], logits, new_cache
    return decode_step


def abstract_cache(cfg: ModelConfig, batch: int, s_max: int, mesh, rules,
                   *, device="meta"):
    """The serving cache of ``s_max`` positions as DTensors of local
    shards with no data on ``mesh`` by ``rules`` (the port's layout:
    ``unit`` a list; see ``models.params.abstract``)."""
    specs = tfm.lm_cache_specs(cfg, batch, s_max)
    return abstract(specs, torch_dtype(cfg.dtype),
                    shardings_tree=shardings(specs, mesh, rules),
                    device=device)


def _grow_block(blk: dict, max_seq: int, mesh, rules) -> dict:
    if "k" not in blk:
        return blk
    out = dict(blk)
    for name in ("k", "v"):
        src = blk[name]
        shape = (src.shape[0], max_seq) + tuple(src.shape[2:])
        if is_dtensor(src):
            dst = zeros_on(shape, src.dtype, make_sharding(
                mesh or src.device_mesh, rules or current_rules(),
                CACHE_AXES, shape), src.to_local().device)
        else:
            dst = src.new_zeros(shape)
        write_seq(dst, src, 0)
        out[name] = dst
    return out


def grow_cache(cache: dict, max_seq: int, mesh=None,
               rules: ShardingRules | None = None) -> dict:
    """The prefill cache with every self-attention ``k`` / ``v`` copied
    into zeros of ``max_seq`` positions (DTensors on ``rules``'
    placements for ``(batch, cache_seq, kv_heads, head_dim)``; each rank
    copies the positions of its shard); cross K/V (``ck`` / ``cv``), SSM
    and conv states are kept as they are, the same tensors."""
    grow = lambda blk: _grow_block(blk, max_seq, mesh, rules)
    out = {"unit": [{key: grow(blk) for key, blk in unit.items()}
                    for unit in cache["unit"]]}
    if "tail" in cache:
        out["tail"] = {key: grow(blk) for key, blk in cache["tail"].items()}
    return out


@dataclasses.dataclass
class ServeEngine:
    """Minimal batched serving loop (greedy decoding)."""

    cfg: ModelConfig
    params: tfm.LM
    max_seq: int

    @torch.no_grad()
    def generate(self, prompts: torch.Tensor, num_new: int,
                 enc_frames: torch.Tensor | None = None, *,
                 return_logits: bool = False):
        """prompts: (B, P) int -> (B, P + num_new) int32 tokens.
        ``enc_frames`` (B, F, d_model): an encoder-decoder config's frame
        embeddings, which the prefill encodes.

        With ``return_logits`` also the logits each new token was chosen
        from, (B, num_new, V): the prefill's, then each decode step's.
        """
        cfg = self.cfg
        b, p = prompts.shape
        if num_new < 1:
            raise ValueError(f"num_new must be at least 1: {num_new}")
        if p + num_new - 1 > self.max_seq:
            raise ValueError(f"max_seq {self.max_seq} holds no "
                             f"{p} + {num_new} - 1 positions")
        step = make_decode_step(cfg, None, None)
        logits, cache = make_prefill_step(cfg, None, None)(
            self.params, {"tokens": prompts, "enc_frames": enc_frames})
        cache = grow_cache(cache, self.max_seq)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        out, seen = [prompts.to(torch.int32), tok], [logits]
        for cache_len in range(p, p + num_new - 1):
            tok, logits, cache = step(self.params, cache, tok, cache_len)
            out.append(tok)
            seen.append(logits)
        tokens = torch.cat(out, dim=1)
        if return_logits:
            return tokens, torch.stack(seen, dim=1)
        return tokens
