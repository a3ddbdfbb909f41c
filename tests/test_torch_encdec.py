"""The port's encoder-decoder path (whisper_large_v3) against the JAX
package on the CPU: ``cross_kv`` and ``cross_attention``, ``_encode``, and
for reduced whisper (1 encoder layer, 24 frames) and a 2 + 2-layer
variant with weights carried across in float32: prefill logits and the
whole cache (``ck`` / ``cv`` included), one decode step from the JAX
cache, ``forward_train``, the greedy tokens of ``ServeEngine.generate``
with frames, one bfloat16 prefill, and the serve CLI.

The same NumPy frames (the CLI's ``standard_normal * 0.02``), prompts
and weights go to both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import repro_torch.configs as tconfigs
from repro.configs import EncoderCfg, get_config, reduced
from repro.layers import attention as jattn
from repro.models import transformer as jtfm
from repro.models.params import materialize as jmaterialize
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.configs import EncoderCfg as TEncoderCfg
from repro_torch.core import interop
from repro_torch.layers import attention as tattn
from repro_torch.models import transformer as ttfm
from repro_torch.serve.engine import ServeEngine, grow_cache
from test_torch_lm import F32, REL, REL_BF16, cache_to_np, rel_err, to_np

ARCH = "whisper_large_v3"
PROMPT, NEW = 9, 6
# (encoder layers, decoder layers): reduce()'s 1 + 1, and 2 + 2 so that a
# stack of each runs past its first unit.
VARIANTS = {"reduced": (1, 1), "two_layers": (2, 2)}


def cfgs(variant="reduced", dtype="float32"):
    """Reduced whisper in both packages, with ``VARIANTS[variant]``
    layers, in ``dtype``."""
    n_enc, n_dec = VARIANTS[variant]
    out = []
    for get, red, enc_cfg in ((get_config, reduced, EncoderCfg),
                              (tconfigs.get_config, tconfigs.reduced,
                               TEncoderCfg)):
        c = red(get(ARCH))
        out.append(dataclasses.replace(
            c, dtype=dtype, num_layers=n_dec,
            encoder=enc_cfg(num_layers=n_enc,
                            num_frames=c.encoder.num_frames)))
    return tuple(out)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def frames_for(cfg, batch: int, seed: int) -> np.ndarray:
    """Stub frame embeddings as the serve CLIs draw them."""
    return (np.random.default_rng(seed).standard_normal(
        (batch, cfg.encoder.num_frames, cfg.d_model)) * 0.02) \
        .astype(np.float32)


@pytest.fixture(scope="module")
def served():
    """Per variant: JAX params, the port's LM built from them, prompts,
    frames, and the JAX package's prefill, generate and forward_train."""
    held = {}

    def get(variant):
        if variant in held:
            return held[variant]
        jcfg, tcfg = cfgs(variant)
        jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
        tp = interop.lm_params_from_numpy(tcfg, to_np(jp), device="cpu")
        toks = np.random.default_rng(1).integers(
            0, jcfg.vocab_size, (2, PROMPT), dtype=np.int32)
        frames = frames_for(jcfg, 2, 2)
        jf = jnp.asarray(frames)
        jl, jc = jtfm.prefill(jp, jcfg, jnp.asarray(toks), jf)
        out = np.array(JaxEngine(jcfg, jp, PROMPT + NEW).generate(
            jnp.asarray(toks), NEW, enc_frames=jf))
        full, _ = jtfm.forward_train(jp, jcfg, jnp.asarray(out), jf)
        held[variant] = dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, toks=toks,
                             frames=frames, jl=jl, jc=jc, out=out,
                             full=np.asarray(full))
        return held[variant]
    return get


# -- the layer ---------------------------------------------------------------

@pytest.mark.parametrize("sq", [1, 5])
def test_cross_kv_and_cross_attention_match_jax(sq):
    """A cross block's projections (no bias, no qk-norm even where the
    config has them) over 24 encoder frames; one query row takes the
    decode route, five the prefill route."""
    jcfg, tcfg = cfgs()
    jcfg = dataclasses.replace(jcfg, qkv_bias=True, qk_norm=True)
    tcfg = dataclasses.replace(tcfg, qkv_bias=True, qk_norm=True)
    specs = jattn.attn_specs(jcfg, cross=True)
    assert set(specs) == {"wq", "wk", "wv", "wo"}
    jp = jmaterialize(specs, jax.random.PRNGKey(3), jnp.float32)
    tspecs = tattn.attn_specs(tcfg, cross=True)
    assert {k: s.shape for k, s in tspecs.items()} == \
        {k: s.shape for k, s in specs.items()}
    tp = ttfm.Params(interop._tensors_like(tspecs, to_np(jp), "float32",
                                           "cpu"))
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, sq, jcfg.d_model)).astype(np.float32)
    jk, jv = jattn.cross_kv(jp, jnp.asarray(enc))
    tk, tv = tattn.cross_kv(tp, torch.from_numpy(enc))
    assert tk.shape == (2, 24, jcfg.num_kv_heads, jcfg.resolved_head_dim)
    for g, w in ((tk, jk), (tv, jv)):
        assert_allclose(_np(g), _np(w), rtol=F32, atol=1e-4)
    want = jattn.cross_attention(jp, jcfg, jnp.asarray(x), (jk, jv))
    got = tattn.cross_attention(tp, tcfg, torch.from_numpy(x), (tk, tv))
    assert got.shape == (2, sq, jcfg.d_model)
    assert_allclose(_np(got), _np(want), rtol=F32, atol=1e-4)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_encode_matches_jax(served, variant):
    s = served(variant)
    want = jtfm._encode(s["jp"], s["jcfg"], jnp.asarray(s["frames"]))
    got = ttfm._encode(s["tp"], s["tcfg"], torch.from_numpy(s["frames"]))
    assert got.shape == (2, s["tcfg"].encoder.num_frames, s["tcfg"].d_model)
    assert_allclose(_np(got), _np(want), rtol=F32, atol=1e-4)


# -- the slice as a whole ----------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_logits_and_cache_match_jax(served, variant):
    s = served(variant)
    tl, tc = ttfm.prefill(s["tp"], s["tcfg"], torch.from_numpy(s["toks"]),
                          torch.from_numpy(s["frames"]))
    assert rel_err(tl, s["jl"], s["tcfg"].vocab_size) <= REL
    blk = tc["unit"][0]["0D"]
    assert set(blk) == {"k", "v", "ck", "cv"}
    assert blk["ck"].shape == (2, 24, s["tcfg"].num_kv_heads,
                               s["tcfg"].resolved_head_dim)
    want = jax.tree.leaves(to_np(s["jc"]))
    got = jax.tree.leaves(cache_to_np(tc))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert_allclose(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_step_from_the_jax_cache_matches(served, variant):
    """The JAX prefill cache with ``k`` / ``v`` grown by 3 positions (as
    the JAX engine grows it: ``ck`` / ``cv`` untouched), carried into the
    port; one decode step each, which passes ``ck`` / ``cv`` on."""
    s = served(variant)
    jcfg, tcfg = s["jcfg"], s["tcfg"]
    from jax.tree_util import tree_map_with_path

    def grow(path, x):
        if any(str(getattr(p, "key", "")) in ("k", "v") for p in path):
            pad = [(0, 0)] * x.ndim
            pad[x.ndim - 3] = (0, 3)
            return jnp.pad(x, pad)
        return x

    jc = tree_map_with_path(grow, s["jc"])
    tok = np.array(s["out"][:, PROMPT:PROMPT + 1])
    jl, jc2 = jtfm.decode_step(s["jp"], jcfg, jnp.asarray(tok), jc,
                               jnp.int32(PROMPT))
    tc = interop.lm_cache_from_numpy(tcfg, to_np(jc), device="cpu")
    tl, tc2 = ttfm.decode_step(s["tp"], tcfg, torch.from_numpy(tok), tc,
                               PROMPT)
    assert tc2["unit"][0]["0D"]["ck"] is tc["unit"][0]["0D"]["ck"]
    assert rel_err(tl, jl, tcfg.vocab_size) <= REL
    for g, w in zip(jax.tree.leaves(cache_to_np(tc2)),
                    jax.tree.leaves(to_np(jc2))):
        assert_allclose(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_train_matches_jax(served, variant):
    s = served(variant)
    got, aux = ttfm.forward_train(s["tp"], s["tcfg"],
                                  torch.from_numpy(s["out"]),
                                  torch.from_numpy(s["frames"]))
    assert got.shape == s["full"].shape and float(aux) == 0.0
    assert rel_err(got, s["full"], s["tcfg"].vocab_size) <= REL


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_generate_tokens_match_jax(served, variant):
    """Greedy tokens of a 9-token prompt and 6 new ones, with frames, are
    equal; the decode logits match the JAX ``forward_train`` (which sees
    the encoder output directly, so a decode that lost the cross K/V
    misses it).  At a step where the JAX top-2 margin is below the logits
    tolerance the token may differ; there the sequences are not compared
    past it (``test_torch_lm.py``'s rule)."""
    s = served(variant)
    tcfg = s["tcfg"]
    got, logits = ServeEngine(tcfg, s["tp"], PROMPT + NEW).generate(
        torch.from_numpy(s["toks"]), NEW, torch.from_numpy(s["frames"]),
        return_logits=True)
    got = got.numpy()
    assert got.shape == s["out"].shape == (2, PROMPT + NEW)
    assert np.array_equal(got[:, :PROMPT], s["toks"])
    want_logits = s["full"][:, PROMPT - 1:PROMPT + NEW - 1]
    assert rel_err(logits, want_logits, tcfg.vocab_size) <= REL
    v = tcfg.vocab_size
    for t in range(NEW):
        col = PROMPT + t
        if np.array_equal(got[:, col], s["out"][:, col]):
            continue
        top2 = np.sort(want_logits[:, t, :v], axis=-1)[:, -2:]
        margin = (top2[:, 1] - top2[:, 0]).min()
        assert margin <= REL * np.abs(want_logits[..., :v]).max(), \
            (variant, t)
        break


def test_grow_cache_keeps_the_prefills_cross_kv(served):
    """``grow_cache`` grows ``k`` / ``v`` and hands on the prefill's own
    ``ck`` / ``cv`` (no copy, not zeros); a decode step against a cache
    whose cross K/V were zeroed gives other logits."""
    s = served("reduced")
    tcfg = s["tcfg"]
    _, cache = ttfm.prefill(s["tp"], tcfg, torch.from_numpy(s["toks"]),
                            torch.from_numpy(s["frames"]))
    grown = grow_cache(cache, PROMPT + 4)
    src, dst = cache["unit"][0]["0D"], grown["unit"][0]["0D"]
    assert dst["ck"] is src["ck"] and dst["cv"] is src["cv"]
    assert bool(src["ck"].abs().max() > 0)
    assert dst["k"].shape[1] == PROMPT + 4
    assert torch.equal(dst["k"][:, :PROMPT], src["k"])
    assert not bool(dst["k"][:, PROMPT:].any())
    tok = torch.from_numpy(np.array(s["out"][:, PROMPT:PROMPT + 1]))
    want, _ = ttfm.decode_step(s["tp"], tcfg, tok, grown, PROMPT)
    zeroed = grow_cache(cache, PROMPT + 4)
    for unit in zeroed["unit"]:
        for blk in unit.values():
            blk["ck"], blk["cv"] = (torch.zeros_like(blk["ck"]),
                                    torch.zeros_like(blk["cv"]))
    got, _ = ttfm.decode_step(s["tp"], tcfg, tok, zeroed, PROMPT)
    assert rel_err(got, want.numpy(), tcfg.vocab_size) > 100 * REL


def test_cache_carries_both_ways(served):
    s = served("two_layers")
    tree = to_np(s["jc"])
    tc = interop.lm_cache_from_numpy(s["tcfg"], tree, device="cpu")
    assert tc["unit"][1]["0D"]["cv"].shape == \
        tree["unit"]["0D"]["cv"].shape[1:]
    back = cache_to_np(tc)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert np.array_equal(g, w)


def test_enc_dec_entry_points_need_frames(served):
    s = served("reduced")
    with pytest.raises(ValueError, match="enc_frames"):
        ttfm.prefill(s["tp"], s["tcfg"], torch.from_numpy(s["toks"]))


def test_bf16_prefill_within_archs_limit():
    """One bfloat16 case, held to tests/test_archs.py's 0.06 limit; the
    frames are cast to the model's dtype as in the JAX package."""
    jcfg, tcfg = cfgs("reduced", "bfloat16")
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = interop.lm_params_from_numpy(tcfg, to_np(jp), device="cpu")
    toks = np.random.default_rng(2).integers(0, 503, (2, 11), dtype=np.int32)
    frames = frames_for(jcfg, 2, 3)
    jl, _ = jtfm.prefill(jp, jcfg, jnp.asarray(toks), jnp.asarray(frames))
    tl, tc = ttfm.prefill(tp, tcfg, torch.from_numpy(toks),
                          torch.from_numpy(frames))
    assert tl.dtype == torch.bfloat16
    assert tc["unit"][0]["0D"]["ck"].dtype == torch.bfloat16
    assert rel_err(tl, jl, 503) < REL_BF16


def test_serve_cli_runs_whisper_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "5", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "arch=whisper_large_v3_smoke device=cpu (host clock) " \
        "generated (2, 8)" in out
