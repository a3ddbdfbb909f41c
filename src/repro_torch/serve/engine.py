"""Serving: prefill / decode step factories and a batched greedy engine.

Counterpart of ``repro/serve/engine.py`` on one card: no mesh, no
sharding rules (``abstract_cache`` serves the JAX package's dry-run and
is not ported).  The self-attention caches are allocated at ``max_seq``
before the first decode step, as the JAX engine grows them, and each
decode step writes its key and value into them in place.  An
encoder-decoder config's cross K/V (``ck`` / ``cv``) stay the prefill's
own tensors, as the JAX engine pads only ``k`` and ``v``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig
from ..models import transformer as tfm


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return tfm.prefill(params, cfg, batch["tokens"],
                           batch.get("enc_frames"))
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, cache, tokens, cache_len: int):
        logits, new_cache = tfm.decode_step(params, cfg, tokens, cache,
                                            cache_len)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok[:, None], logits, new_cache
    return decode_step


def _grow_block(blk: dict, max_seq: int) -> dict:
    if "k" not in blk:
        return blk
    out = dict(blk)
    for name in ("k", "v"):
        src = blk[name]
        out[name] = src.new_zeros((src.shape[0], max_seq) + src.shape[2:])
        out[name][:, :src.shape[1]] = src
    return out


def grow_cache(cache: dict, max_seq: int) -> dict:
    """The prefill cache with every self-attention ``k`` / ``v`` copied
    into zeros of ``max_seq`` positions; cross K/V (``ck`` / ``cv``), SSM
    and conv states are kept as they are, the same tensors."""
    out = {"unit": [{key: _grow_block(blk, max_seq)
                     for key, blk in unit.items()}
                    for unit in cache["unit"]]}
    if "tail" in cache:
        out["tail"] = {key: _grow_block(blk, max_seq)
                       for key, blk in cache["tail"].items()}
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
        step = make_decode_step(cfg)
        logits, cache = make_prefill_step(cfg)(
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
