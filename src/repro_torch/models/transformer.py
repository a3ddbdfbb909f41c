"""Decoder-LM assembly for the ``D`` / ``A`` / ``M`` block types.

Counterpart of ``repro/models/transformer.py``.  The JAX package scans
over stacked pattern units; the port keeps one module per unit in a
``ModuleList`` and loops over them in Python.  Parameters keep the JAX
package's names, nesting and layouts (``unit`` is a list of units instead
of one tree stacked along a leading axis), so weights carried across
are copies.

Three entry modes, all forward only (no autograd):
  * ``forward_train`` -- full-sequence causal, returns (logits, aux_loss)
  * ``prefill``       -- same math, also returns the serving cache
  * ``decode_step``   -- one token against the cache (KV / SSM state)

MoE blocks (``E``) and encoder-decoder configs are not ported yet
(ROADMAP A11): they raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..layers import attention as attn
from ..layers import ssd
from ..layers.core import (embed, embed_specs, logits_fn, mlp, mlp_specs,
                           rmsnorm, rmsnorm_spec)
from .params import ParamSpec, materialize, torch_dtype

PORTED_BLOCKS = "DAM"


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet."""
    chars = set(cfg.pattern_unit + cfg.tail)
    if cfg.is_enc_dec or not chars <= set(PORTED_BLOCKS):
        raise NotImplementedError(
            f"{cfg.name}: MoE (E) blocks and encoder-decoder configs are not "
            "ported to repro_torch yet (ROADMAP A11)")


# --------------------------------------------------------------------------
# Parameter specs.
# --------------------------------------------------------------------------

def block_specs(cfg: ModelConfig, char: str) -> dict:
    if char == "M":
        return {"ln": rmsnorm_spec(cfg.d_model), "mamba": ssd.ssd_specs(cfg)}
    return {"ln1": rmsnorm_spec(cfg.d_model), "attn": attn.attn_specs(cfg),
            "ln2": rmsnorm_spec(cfg.d_model),
            "mlp": mlp_specs(cfg.d_model, cfg.d_ff)}


def _stack(spec_tree: dict, n: int) -> dict:
    """Specs with a leading layer axis of ``n``, as the JAX package stacks
    its units (the fan-in of a stacked weight counts that axis too)."""
    return {k: (ParamSpec((n,) + s.shape, ("layers",) + s.axes, init=s.init,
                          scale=s.scale, dtype=s.dtype)
                if isinstance(s, ParamSpec) else _stack(s, n))
            for k, s in spec_tree.items()}


def _unstack(tree: dict, n: int) -> list[dict]:
    """The n per-unit trees of a tree stacked along its leading axis."""
    out = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
        for i in range(n):
            out[i][k] = parts[i]
    return out


def param_specs(cfg: ModelConfig) -> dict:
    check_supported(cfg)
    unit = {f"{j}{c}": block_specs(cfg, c)
            for j, c in enumerate(cfg.pattern_unit)}
    specs = {"embed": embed_specs(cfg),
             "final_norm": rmsnorm_spec(cfg.d_model),
             "unit": _stack(unit, cfg.num_units)}
    if cfg.tail:
        specs["tail"] = {f"{j}{c}": block_specs(cfg, c)
                         for j, c in enumerate(cfg.tail)}
    return specs


class Params(nn.Module):
    """A tree of tensors under the JAX package's names: leaves are
    parameters (frozen: the port serves), inner dicts submodules.  Read it
    like the JAX dict: ``params["wq"]``, ``"bq" in params``."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, Params(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


class Block(Params):
    """One block: ``M`` (Mamba2), or ``D`` / ``A`` (attention + MLP)."""

    def __init__(self, char: str, tree: dict):
        super().__init__(tree)
        self.char = char

    def forward(self, cfg, h, positions, mode: str, cache=None,
                cache_len: int | None = None):
        return _block_fwd(self.char, self, cfg, h, positions, mode, cache,
                          cache_len)


class LM(Params):
    """The whole decoder: ``embed``, ``unit`` (a ``ModuleList`` of units,
    each a ``ModuleDict`` of blocks keyed as in JAX, ``"0M"``...),
    ``tail`` and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        check_supported(cfg)
        rest = {k: v for k, v in tree.items() if k not in ("unit", "tail")}
        super().__init__(rest)
        self.cfg = cfg
        if len(tree["unit"]) != cfg.num_units:
            raise ValueError(f"{len(tree['unit'])} units, the config has "
                             f"{cfg.num_units}")
        self.unit = nn.ModuleList(
            nn.ModuleDict({key: Block(key[-1], blk)
                           for key, blk in u.items()})
            for u in tree["unit"])
        if cfg.tail:
            self.tail = nn.ModuleDict({key: Block(key[-1], blk)
                                       for key, blk in tree["tail"].items()})


def lm_from_tree(cfg: ModelConfig, tree: dict) -> LM:
    """An ``LM`` from a tree shaped like the JAX parameters, with ``unit``
    stacked along its leading axis."""
    tree = dict(tree, unit=_unstack(tree["unit"], cfg.num_units))
    return LM(cfg, tree)


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                *, device=None) -> LM:
    """Random weights by the JAX package's init rules, drawn from
    ``generator`` (default: seed 0 on ``device``, which defaults to
    ``cuda`` and raises without a card)."""
    if generator is None:
        from ..core.relation import resolve_device

        generator = torch.Generator(device=resolve_device(device))
        generator.manual_seed(0)
    tree = materialize(param_specs(cfg), generator, torch_dtype(cfg.dtype))
    return lm_from_tree(cfg, tree)


# --------------------------------------------------------------------------
# Cache specs (serving).
# --------------------------------------------------------------------------

def _block_cache_specs(cfg: ModelConfig, char: str, batch: int,
                       s_max: int) -> dict:
    if char == "M":
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        nh = d_in // s.head_dim
        k = s.conv_kernel
        return {
            "ssm": ParamSpec((batch, nh, s.head_dim, s.d_state),
                             ("batch", "ssm_heads", None, None),
                             init="zeros", dtype="float32"),
            "conv_x": ParamSpec((batch, k - 1, d_in),
                                ("batch", None, "mlp"), init="zeros"),
            "conv_b": ParamSpec((batch, k - 1, s.d_state),
                                ("batch", None, None), init="zeros"),
            "conv_c": ParamSpec((batch, k - 1, s.d_state),
                                ("batch", None, None), init="zeros"),
        }
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    axes = ("batch", "cache_seq", "kv_heads", "head_dim")
    return {"k": ParamSpec((batch, s_max, kv, hd), axes, init="zeros"),
            "v": ParamSpec((batch, s_max, kv, hd), axes, init="zeros")}


def cache_specs(cfg: ModelConfig, batch: int, s_max: int) -> dict:
    check_supported(cfg)
    unit = {f"{j}{c}": _block_cache_specs(cfg, c, batch, s_max)
            for j, c in enumerate(cfg.pattern_unit)}
    specs = {"unit": _stack(unit, cfg.num_units)}
    if cfg.tail:
        specs["tail"] = {f"{j}{c}": _block_cache_specs(cfg, c, batch, s_max)
                         for j, c in enumerate(cfg.tail)}
    return specs


def init_cache(cfg: ModelConfig, batch: int, s_max: int, device) -> dict:
    """Zero caches: ``{"unit": [per-unit dict], "tail": {...}}``; the SSM
    state in float32, the rest in the model's dtype."""
    tree = materialize(cache_specs(cfg, batch, s_max), None,
                       torch_dtype(cfg.dtype), device)
    tree["unit"] = _unstack(tree["unit"], cfg.num_units)
    return tree


# --------------------------------------------------------------------------
# Block forward.
# --------------------------------------------------------------------------

def _block_fwd(char: str, params, cfg: ModelConfig, h: torch.Tensor,
               positions, mode: str, cache: dict | None, cache_len):
    """One block.  Returns (h, new_cache)."""
    if char == "M":
        state = None
        if mode == "decode":
            state = {k: cache[k] for k in ("ssm", "conv_x", "conv_b",
                                           "conv_c")}
        x = rmsnorm(h, params["ln"], cfg.rms_eps)
        y, st = ssd.mamba_block(params["mamba"], cfg, x, state)
        return h + y, st
    if char not in "DA":
        raise NotImplementedError(f"block {char!r} is not ported to "
                                  "repro_torch yet (ROADMAP A11)")
    x = rmsnorm(h, params["ln1"], cfg.rms_eps)
    new_cache: dict = {}
    if mode == "decode":
        y, k_c, v_c = attn.decode_attention(params["attn"], cfg, x,
                                            cache["k"], cache["v"],
                                            cache_len)
        new_cache = {"k": k_c, "v": v_c}
    else:
        y, (k_c, v_c) = attn.attention(params["attn"], cfg, x, positions,
                                       causal=True)
        if mode == "prefill":
            new_cache = {"k": k_c, "v": v_c}
    h = h + y
    x2 = rmsnorm(h, params["ln2"], cfg.rms_eps)
    return h + mlp(params["mlp"], x2), new_cache


# --------------------------------------------------------------------------
# Stack and entry points.
# --------------------------------------------------------------------------

def _run_stack(params: LM, cfg: ModelConfig, h, positions, mode: str,
               cache, cache_len, want_cache: bool):
    """Every unit in order, then the tail.  Returns (h, new_cache)."""
    new_units = []
    for i, unit in enumerate(params.unit):
        unit_cache = cache["unit"][i] if cache is not None else None
        new_unit = {}
        for j, c in enumerate(cfg.pattern_unit):
            key = f"{j}{c}"
            h, new_unit[key] = unit[key](
                cfg, h, positions, mode,
                unit_cache[key] if unit_cache is not None else None,
                cache_len)
        new_units.append(new_unit)
    new_cache = {"unit": new_units} if want_cache else {}
    if cfg.tail:
        new_tail = {}
        for key, blk in params.tail.items():
            h, new_tail[key] = blk(
                cfg, h, positions, mode,
                cache["tail"][key] if cache is not None else None,
                cache_len)
        if want_cache:
            new_cache["tail"] = new_tail
    return h, new_cache


def _positions(b: int, s: int, device, start: int = 0) -> torch.Tensor:
    return (torch.arange(s, dtype=torch.int32, device=device)
            + start).expand(b, s)


@torch.no_grad()
def forward_hidden(params: LM, cfg: ModelConfig, tokens: torch.Tensor):
    """tokens: (B, S) -> (final hidden states (B, S, d), aux_loss)."""
    b, s = tokens.shape
    h = embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    h, _ = _run_stack(params, cfg, h, _positions(b, s, tokens.device),
                      "train", None, None, want_cache=False)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return rmsnorm(h, params["final_norm"], cfg.rms_eps), aux


@torch.no_grad()
def forward_train(params: LM, cfg: ModelConfig, tokens: torch.Tensor):
    """tokens: (B, S) -> (logits (B, S, V), aux_loss).  Forward only."""
    h, aux = forward_hidden(params, cfg, tokens)
    return logits_fn(params["embed"], h, cfg.vocab_size), aux


@torch.no_grad()
def prefill(params: LM, cfg: ModelConfig, tokens: torch.Tensor):
    """Returns (last-position logits (B, V), cache)."""
    b, s = tokens.shape
    h = embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    h, cache = _run_stack(params, cfg, h, _positions(b, s, tokens.device),
                          "prefill", None, None, want_cache=True)
    h = rmsnorm(h[:, -1:], params["final_norm"], cfg.rms_eps)
    return logits_fn(params["embed"], h, cfg.vocab_size)[:, 0], cache


@torch.no_grad()
def decode_step(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict, cache_len: int):
    """tokens: (B, 1); ``cache_len`` tokens are already in the cache.
    The attention caches are updated in place.  Returns (logits (B, V),
    new_cache)."""
    b, _ = tokens.shape
    h = embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    h, new_cache = _run_stack(params, cfg, h,
                              _positions(b, 1, tokens.device, cache_len),
                              "decode", cache, cache_len, want_cache=True)
    h = rmsnorm(h, params["final_norm"], cfg.rms_eps)
    return logits_fn(params["embed"], h, cfg.vocab_size)[:, 0], new_cache
