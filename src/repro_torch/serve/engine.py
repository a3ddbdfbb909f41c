"""Serving: prefill / decode step factories and a batched greedy engine.

Counterpart of ``repro/serve/engine.py`` on one card: no mesh, no
sharding rules (``abstract_cache`` serves the JAX package's dry-run and
is not ported).  The attention caches are allocated at ``max_seq``
before the first decode step, as the JAX engine grows them, and each
decode step writes its key and value into them in place.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig
from ..models import transformer as tfm


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return tfm.prefill(params, cfg, batch["tokens"])
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, cache, tokens, cache_len: int):
        logits, new_cache = tfm.decode_step(params, cfg, tokens, cache,
                                            cache_len)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok[:, None], logits, new_cache
    return decode_step


def grow_cache(cfg: ModelConfig, cache: dict, batch: int, max_seq: int,
               device) -> dict:
    """The prefill cache with every attention cache copied into zeros of
    ``max_seq`` positions; SSM and conv states are kept as they are."""
    out = tfm.init_cache(cfg, batch, max_seq, device)
    units = list(zip(out["unit"], cache["unit"]))
    if cfg.tail:
        units.append((out["tail"], cache["tail"]))
    for dst_unit, src_unit in units:
        for key, src in src_unit.items():
            if "k" in src:
                for name in ("k", "v"):
                    s = src[name].shape[1]
                    dst_unit[key][name][:, :s] = src[name]
            else:
                dst_unit[key] = src
    return out


@dataclasses.dataclass
class ServeEngine:
    """Minimal batched serving loop (greedy decoding)."""

    cfg: ModelConfig
    params: tfm.LM
    max_seq: int

    @torch.no_grad()
    def generate(self, prompts: torch.Tensor, num_new: int, *,
                 return_logits: bool = False):
        """prompts: (B, P) int -> (B, P + num_new) int32 tokens.

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
        logits, cache = make_prefill_step(cfg)(self.params,
                                               {"tokens": prompts})
        cache = grow_cache(cfg, cache, b, self.max_seq, prompts.device)
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
