"""LM assembly for the ``D`` / ``A`` / ``M`` / ``E`` block types, and the
encoder-decoder wrapper (whisper).

Counterpart of ``repro/models/transformer.py``.  The JAX package scans
over stacked pattern units; the port keeps one module per unit in a
``ModuleList`` and loops over them in Python.  Parameters keep the JAX
package's names, nesting and layouts (``unit`` is a list of units instead
of one tree stacked along a leading axis), so weights carried across
are copies.

Three entry modes:
  * ``forward_train`` -- full-sequence causal, returns (logits, aux_loss);
    it and ``forward_hidden`` run under autograd where the parameters
    require gradients (``train/step.py`` sets them so)
  * ``prefill``       -- same math, also returns the serving cache
  * ``decode_step``   -- one token against the cache (KV / SSM state)
The last two never record a graph.  Under autograd each unit is
rematerialised as ``cfg.remat`` says (``"full"``, ``"dots"`` or
``"none"``), as the JAX package checkpoints its scanned unit body; the
tail is not.

An encoder-decoder config (``cfg.encoder``) first runs ``_encode`` over
its stub frame embeddings (B, F, d_model): a stack of non-causal ``D``
blocks and its own final norm.  Each decoder block then adds cross
attention over the encoder output, whose keys and values the prefill
keeps in the cache as ``ck`` / ``cv``.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..configs.base import ModelConfig
from ..layers import attention as attn
from ..layers import moe as moe_lib
from ..layers import ssd
from ..layers.core import (embed, embed_specs, logits_fn, mlp, mlp_specs,
                           rmsnorm, rmsnorm_spec)
from .params import ParamSpec, materialize, torch_dtype

PORTED_BLOCKS = "DAME"


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a block type the port does not run."""
    chars = set(cfg.pattern_unit + cfg.tail)
    if not chars <= set(PORTED_BLOCKS):
        raise NotImplementedError(
            f"{cfg.name}: block types {sorted(chars - set(PORTED_BLOCKS))} "
            f"are not ported to repro_torch (it runs {PORTED_BLOCKS})")


# --------------------------------------------------------------------------
# Parameter specs.
# --------------------------------------------------------------------------

def block_specs(cfg: ModelConfig, char: str, *, cross: bool = False) -> dict:
    """One block's specs; ``cross`` adds the decoder's cross attention
    (``ln_cross``, ``cross``) of an encoder-decoder config."""
    if char == "M":
        return {"ln": rmsnorm_spec(cfg.d_model), "mamba": ssd.ssd_specs(cfg)}
    out = {"ln1": rmsnorm_spec(cfg.d_model), "attn": attn.attn_specs(cfg),
           "ln2": rmsnorm_spec(cfg.d_model)}
    if char == "E":
        out["moe"] = moe_lib.moe_specs(cfg)
    else:
        out["mlp"] = mlp_specs(cfg.d_model, cfg.d_ff)
    if cross:
        out["ln_cross"] = rmsnorm_spec(cfg.d_model)
        out["cross"] = attn.attn_specs(cfg, cross=True)
    return out


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
    cross = cfg.is_enc_dec
    unit = {f"{j}{c}": block_specs(cfg, c, cross=cross)
            for j, c in enumerate(cfg.pattern_unit)}
    specs = {"embed": embed_specs(cfg),
             "final_norm": rmsnorm_spec(cfg.d_model),
             "unit": _stack(unit, cfg.num_units)}
    if cfg.tail:
        specs["tail"] = {f"{j}{c}": block_specs(cfg, c, cross=cross)
                         for j, c in enumerate(cfg.tail)}
    if cfg.encoder:
        enc_unit = {"0D": block_specs(cfg, "D")}
        specs["encoder"] = {"unit": _stack(enc_unit, cfg.encoder.num_layers),
                            "final_norm": rmsnorm_spec(cfg.d_model)}
    return specs


class Params(nn.Module):
    """A tree of tensors under the JAX package's names: leaves are
    parameters (frozen until a trainer calls ``requires_grad_()``), inner
    dicts submodules.  Read it like the JAX dict: ``params["wq"]``,
    ``"bq" in params``."""

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
    """One block: ``M`` (Mamba2), ``D`` / ``A`` (attention + MLP) or
    ``E`` (attention + MoE), with cross attention where it has
    ``cross``."""

    def __init__(self, char: str, tree: dict):
        super().__init__(tree)
        self.char = char

    def forward(self, cfg, h, positions, mode: str, cache=None,
                cache_len: int | None = None, enc_out=None):
        return _block_fwd(self.char, self, cfg, h, positions, mode, cache,
                          cache_len, enc_out)


def _blocks(tree: dict) -> nn.ModuleDict:
    """Blocks keyed as in JAX (``"0M"``...), each typed by its last
    character."""
    return nn.ModuleDict({key: Block(key[-1], blk)
                          for key, blk in tree.items()})


class Stack(Params):
    """A stack of blocks: ``unit`` (a ``ModuleList`` of units, each a
    ``ModuleDict`` of blocks), ``tail`` where the tree has one, and the
    other leaves and subtrees (``final_norm``...) as ``Params``."""

    def __init__(self, tree: dict, num_units: int):
        rest = {k: v for k, v in tree.items() if k not in ("unit", "tail")}
        super().__init__(rest)
        if len(tree["unit"]) != num_units:
            raise ValueError(f"{len(tree['unit'])} units, the config has "
                             f"{num_units}")
        self.unit = nn.ModuleList(_blocks(u) for u in tree["unit"])
        if "tail" in tree:
            self.tail = _blocks(tree["tail"])


class LM(Stack):
    """The whole model: ``embed``, the decoder's ``unit`` and ``tail``,
    ``final_norm`` and, for an encoder-decoder config, ``encoder`` (a
    ``Stack`` of its own ``unit`` and ``final_norm``)."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        check_supported(cfg)
        if ("tail" in tree) != bool(cfg.tail) or \
                ("encoder" in tree) != cfg.is_enc_dec:
            raise ValueError(f"tree {sorted(tree)} does not fit {cfg.name}")
        super().__init__({k: v for k, v in tree.items() if k != "encoder"},
                         cfg.num_units)
        self.cfg = cfg
        if cfg.encoder:
            self.encoder = Stack(tree["encoder"], cfg.encoder.num_layers)


def lm_from_tree(cfg: ModelConfig, tree: dict) -> LM:
    """An ``LM`` from a tree shaped like the JAX parameters, with ``unit``
    (and the encoder's ``unit``) stacked along its leading axis."""
    tree = dict(tree, unit=_unstack(tree["unit"], cfg.num_units))
    if cfg.encoder:
        enc = tree["encoder"]
        tree["encoder"] = dict(enc, unit=_unstack(enc["unit"],
                                                  cfg.encoder.num_layers))
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
                       s_max: int, *, cross: bool = False) -> dict:
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
    out = {"k": ParamSpec((batch, s_max, kv, hd), axes, init="zeros"),
           "v": ParamSpec((batch, s_max, kv, hd), axes, init="zeros")}
    if cross:
        f = cfg.encoder.num_frames
        axes = ("batch", None, "kv_heads", "head_dim")
        out["ck"] = ParamSpec((batch, f, kv, hd), axes, init="zeros")
        out["cv"] = ParamSpec((batch, f, kv, hd), axes, init="zeros")
    return out


def cache_specs(cfg: ModelConfig, batch: int, s_max: int) -> dict:
    """The serving cache: ``k`` / ``v`` of ``s_max`` positions per
    attention block (and the encoder's ``ck`` / ``cv`` in an
    encoder-decoder config), SSM and conv states per ``M`` block; the SSM
    state in float32, the rest in the model's dtype."""
    check_supported(cfg)
    cross = cfg.is_enc_dec
    unit = {f"{j}{c}": _block_cache_specs(cfg, c, batch, s_max, cross=cross)
            for j, c in enumerate(cfg.pattern_unit)}
    specs = {"unit": _stack(unit, cfg.num_units)}
    if cfg.tail:
        specs["tail"] = {f"{j}{c}": _block_cache_specs(cfg, c, batch, s_max,
                                                       cross=cross)
                         for j, c in enumerate(cfg.tail)}
    return specs


# --------------------------------------------------------------------------
# Block forward.
# --------------------------------------------------------------------------

def _block_fwd(char: str, params, cfg: ModelConfig, h: torch.Tensor,
               positions, mode: str, cache: dict | None, cache_len,
               enc_out=None):
    """One block in ``mode`` ("train", "prefill", "decode" or "encode":
    non-causal, no cache).  A block with ``cross`` adds cross attention
    over ``enc_out`` (train, prefill: the prefill keeps its keys and values
    as ``ck`` / ``cv``) or over the cache's ``ck`` / ``cv`` (decode: passed
    on unchanged).  Returns (h, new_cache, aux): aux is the MoE
    load-balance loss of an ``E`` block, 0.0 for the others."""
    if char == "M":
        state = None
        if mode == "decode":
            state = {k: cache[k] for k in ("ssm", "conv_x", "conv_b",
                                           "conv_c")}
        x = rmsnorm(h, params["ln"], cfg.rms_eps)
        y, st = ssd.mamba_block(params["mamba"], cfg, x, state)
        return h + y, st, 0.0
    x = rmsnorm(h, params["ln1"], cfg.rms_eps)
    new_cache: dict = {}
    ckv = None
    if mode == "decode":
        y, k_c, v_c = attn.decode_attention(params["attn"], cfg, x,
                                            cache["k"], cache["v"],
                                            cache_len)
        new_cache = {"k": k_c, "v": v_c}
        if "cross" in params:
            ckv = (cache["ck"], cache["cv"])
    else:
        y, (k_c, v_c) = attn.attention(params["attn"], cfg, x, positions,
                                       causal=(mode != "encode"))
        if mode == "prefill":
            new_cache = {"k": k_c, "v": v_c}
        if "cross" in params and enc_out is not None:
            ckv = attn.cross_kv(params["cross"], enc_out)
    if ckv is not None:
        # The JAX package's order: the cross term joins the self-attention
        # output before the residual (bfloat16 rounds each add).
        xc = rmsnorm(h + y, params["ln_cross"], cfg.rms_eps)
        y = y + attn.cross_attention(params["cross"], cfg, xc, ckv)
        if mode in ("prefill", "decode"):
            new_cache["ck"], new_cache["cv"] = ckv
    h = h + y
    x2 = rmsnorm(h, params["ln2"], cfg.rms_eps)
    if char == "E":
        y2, aux = moe_lib.moe(params["moe"], cfg, x2)
        return h + y2, new_cache, aux
    return h + mlp(params["mlp"], x2), new_cache, 0.0


# --------------------------------------------------------------------------
# Stacks and entry points.
# --------------------------------------------------------------------------

def _mm_saveable(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of plain matrix products
    (JAX's dots with no batch dims), recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _unit_fwd(unit, cfg: ModelConfig, pattern_unit: str, mode: str, h,
              positions, unit_cache, cache_len, enc_out):
    """One unit's blocks in order: (h, aux of its blocks, its new cache)."""
    aux = 0.0
    new_unit = {}
    for j, c in enumerate(pattern_unit):
        key = f"{j}{c}"
        h, new_unit[key], a = unit[key](
            cfg, h, positions, mode,
            unit_cache[key] if unit_cache is not None else None,
            cache_len, enc_out)
        aux = aux + a
    return h, aux, new_unit


def _remat(cfg: ModelConfig, fn, records: bool):
    """``fn`` checkpointed as ``cfg.remat`` says where autograd
    ``records`` (elsewhere a checkpoint only costs host time)."""
    if cfg.remat == "none" or not records:
        return fn
    if cfg.remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _mm_saveable))
    raise ValueError(f"remat {cfg.remat!r}: none, full or dots")


def _run_stack(params: Stack, cfg: ModelConfig, h, positions, mode: str,
               cache, cache_len, enc_out, pattern_unit: str,
               want_cache: bool):
    """Every unit of ``pattern_unit`` blocks in order, each checkpointed
    as ``cfg.remat`` says under autograd, then the tail where ``params``
    has one.  Returns (h, aux, new_cache): aux sums the blocks' MoE
    losses (a float32 tensor, or 0.0 where no block is ``E``: a Python
    float adds no launch per block)."""
    aux = 0.0
    new_units = []
    records = torch.is_grad_enabled() and (
        h.requires_grad or any(p.requires_grad for p in params.parameters()))
    unit_fwd = _remat(cfg, _unit_fwd, records)
    for i, unit in enumerate(params.unit):
        unit_cache = cache["unit"][i] if cache is not None else None
        h, a, new_unit = unit_fwd(unit, cfg, pattern_unit, mode, h,
                                  positions, unit_cache, cache_len, enc_out)
        aux = aux + a
        new_units.append(new_unit)
    new_cache = {"unit": new_units} if want_cache else {}
    if "tail" in params:
        new_tail = {}
        for key, blk in params.tail.items():
            h, new_tail[key], a = blk(
                cfg, h, positions, mode,
                cache["tail"][key] if cache is not None else None,
                cache_len, enc_out)
            aux = aux + a
        if want_cache:
            new_cache["tail"] = new_tail
    return h, aux, new_cache


def _positions(b: int, s: int, device, start: int = 0) -> torch.Tensor:
    return (torch.arange(s, dtype=torch.int32, device=device)
            + start).expand(b, s)


def _encode(params: LM, cfg: ModelConfig, frames: torch.Tensor):
    """Whisper encoder over stub frontend embeddings (B, F, d): the
    encoder's non-causal ``D`` blocks at positions 0..F-1 (RoPE, the JAX
    package's adaptation), then its final norm."""
    b, f, _ = frames.shape
    enc = params.encoder
    h, _, _ = _run_stack(enc, cfg, frames, _positions(b, f, frames.device),
                         "encode", None, None, None, "D", want_cache=False)
    return rmsnorm(h, enc["final_norm"], cfg.rms_eps)


def _enc_out(params: LM, cfg: ModelConfig, enc_frames):
    """The encoder output of an encoder-decoder config (its frames cast to
    the model's dtype), else None."""
    if not cfg.encoder:
        return None
    if enc_frames is None:
        raise ValueError(f"{cfg.name} is encoder-decoder: pass enc_frames "
                         f"(B, {cfg.encoder.num_frames}, {cfg.d_model})")
    return _encode(params, cfg, enc_frames.to(torch_dtype(cfg.dtype)))


def forward_hidden(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
                   enc_frames: torch.Tensor | None = None):
    """tokens: (B, S) -> (final hidden states (B, S, d), aux_loss: a
    float32 scalar that carries its gradient)."""
    b, s = tokens.shape
    h = embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    enc_out = _enc_out(params, cfg, enc_frames)
    h, aux, _ = _run_stack(params, cfg, h, _positions(b, s, tokens.device),
                           "train", None, None, enc_out, cfg.pattern_unit,
                           want_cache=False)
    if not isinstance(aux, torch.Tensor):
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return rmsnorm(h, params["final_norm"], cfg.rms_eps), aux


def forward_train(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
                  enc_frames: torch.Tensor | None = None):
    """tokens: (B, S) -> (logits (B, S, V), aux_loss)."""
    h, aux = forward_hidden(params, cfg, tokens, enc_frames)
    return logits_fn(params["embed"], h, cfg.vocab_size), aux


@torch.no_grad()
def prefill(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
            enc_frames: torch.Tensor | None = None):
    """Returns (last-position logits (B, V), cache)."""
    b, s = tokens.shape
    h = embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    enc_out = _enc_out(params, cfg, enc_frames)
    h, _, cache = _run_stack(params, cfg, h,
                             _positions(b, s, tokens.device), "prefill",
                             None, None, enc_out, cfg.pattern_unit,
                             want_cache=True)
    h = rmsnorm(h[:, -1:], params["final_norm"], cfg.rms_eps)
    return logits_fn(params["embed"], h, cfg.vocab_size)[:, 0], cache


@torch.no_grad()
def decode_step(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict, cache_len: int):
    """tokens: (B, 1); ``cache_len`` tokens are already in the cache (and
    an encoder-decoder config's cross K/V).  The attention caches are
    updated in place.  Returns (logits (B, V), new_cache)."""
    b, _ = tokens.shape
    h = embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    h, _, new_cache = _run_stack(params, cfg, h,
                                 _positions(b, 1, tokens.device, cache_len),
                                 "decode", cache, cache_len, None,
                                 cfg.pattern_unit, want_cache=True)
    h = rmsnorm(h, params["final_norm"], cfg.rms_eps)
    return logits_fn(params["embed"], h, cfg.vocab_size)[:, 0], new_cache
