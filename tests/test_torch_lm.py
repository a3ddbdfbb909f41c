"""The port's LM serving slice against the JAX package on the CPU: the
primitive layers, attention (qk-norm, qkv-bias, decode), and, for reduced
Zamba2, Mamba2 and Qwen3 with weights carried across, prefill logits and
caches, decode-step logits and the greedy tokens of
``ServeEngine.generate``.

Logits are compared over the real vocabulary: the padded entries are
-1e9 in both packages and would make any relative limit vacuous."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import repro_torch.configs as tconfigs
from repro.configs import get_config, reduced
from repro.layers import attention as jattn
from repro.layers import core as jcore
from repro.models import transformer as jtfm
from repro.models.params import materialize as jmaterialize
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.core import interop
from repro_torch.layers import attention as tattn
from repro_torch.layers import core as tcore
from repro_torch.models import params as tparams
from repro_torch.models import transformer as ttfm
from repro_torch.serve.engine import ServeEngine

F32 = 1e-5
REL = 1e-4          # logits: max|d| <= 1e-4 max|logits| in float32
REL_BF16 = 0.06     # tests/test_archs.py's limit for bfloat16
SLICE_ARCHS = ["zamba2_1_2b", "mamba2_2_7b", "qwen3_8b"]
PROMPT, NEW = 37, 8


def cfgs(arch, dtype="float32"):
    """The reduced config in both packages, in ``dtype``."""
    j = dataclasses.replace(reduced(get_config(arch)), dtype=dtype)
    t = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)),
                            dtype=dtype)
    return j, t


def to_np(tree):
    return jax.tree.map(lambda v: np.asarray(v, np.float32), tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def rel_err(got, want, vocab):
    g, w = _np(got)[..., :vocab], _np(want)[..., :vocab]
    return np.abs(g - w).max() / np.abs(w).max()


def cache_to_np(cache: dict) -> dict:
    """A port cache as NumPy float32 in the JAX layout (``unit``
    stacked along a leading axis)."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return t.float().numpy()

    units = [conv(u) for u in cache["unit"]]
    out = {"unit": jax.tree.map(lambda *xs: np.stack(xs), *units)}
    if "tail" in cache:
        out["tail"] = conv(cache["tail"])
    return out


def _both(a):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


# -- primitive layers --------------------------------------------------------

def test_rmsnorm_rope_mlp_match_jax():
    rng = np.random.default_rng(0)
    x = _both(rng.standard_normal((2, 5, 4, 16)))
    w = _both(rng.uniform(0.5, 1.5, 16))
    assert_allclose(_np(tcore.rmsnorm(x[1], w[1])),
                    _np(jcore.rmsnorm(x[0], w[0])), rtol=F32, atol=F32)
    pos = rng.integers(0, 1000, (2, 5)).astype(np.int32)
    assert_allclose(_np(tcore.apply_rope(x[1], torch.from_numpy(pos), 1e4)),
                    _np(jcore.apply_rope(x[0], jnp.asarray(pos), 1e4)),
                    rtol=F32, atol=1e-4)
    specs = jcore.mlp_specs(16, 32)
    jp = jmaterialize(specs, jax.random.PRNGKey(1), jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    h = _both(rng.standard_normal((2, 5, 16)))
    assert_allclose(_np(tcore.mlp(tp, h[1])), _np(jcore.mlp(jp, h[0])),
                    rtol=F32, atol=F32)


def test_rope_is_half_split():
    x = torch.zeros(1, 1, 1, 4)
    x[..., 0] = 1.0                               # first of the pair (0, 2)
    out = tcore.apply_rope(x, torch.ones(1, 1, dtype=torch.int32), 1.0)
    assert out[..., 2].item() == pytest.approx(np.sin(1.0))
    assert out[..., 1].item() == 0.0


def test_logits_fn_masks_padded_vocab():
    jcfg, tcfg = cfgs("qwen3_8b")
    assert tcfg.vocab_size == 503 and tcfg.padded_vocab == 512
    jp = jmaterialize(jcore.embed_specs(jcfg), jax.random.PRNGKey(2),
                      jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    h = _both(np.random.default_rng(2).standard_normal((2, 3, 64)))
    want = jcore.logits_fn(jp, h[0], 503)
    got = tcore.logits_fn(tp, h[1], 503)
    assert_allclose(_np(got), _np(want), rtol=F32, atol=1e-4)
    assert (_np(got)[..., 503:] == -1e9).all()
    tok = np.array([[0, 502, 7]], np.int32)
    assert_allclose(_np(tcore.embed(tp, torch.from_numpy(tok),
                                    torch.float32)),
                    _np(jcore.embed(jp, jnp.asarray(tok), jnp.float32)))


@pytest.mark.parametrize("arch", ["qwen3_8b", "qwen2_5_14b"])
def test_attention_and_decode_attention_match_jax(arch):
    """qk-norm (Qwen3) and qkv-bias (Qwen2.5), then one decode step
    against a cache holding the prefill's keys and values."""
    jcfg, tcfg = cfgs(arch)
    specs = jattn.attn_specs(jcfg)
    jp = jmaterialize(specs, jax.random.PRNGKey(3), jnp.float32)
    if "bq" in jp:   # zeros at init: make the bias matter
        rng = np.random.default_rng(4)
        jp = {k: (jnp.asarray(rng.standard_normal(v.shape), jnp.float32)
                  if k.startswith("b") else v) for k, v in jp.items()}
    tp = ttfm.Params(interop._tensors_like(tattn.attn_specs(tcfg), to_np(jp),
                                           "float32", "cpu"))
    assert ("q_norm" in tp) == jcfg.qk_norm and ("bq" in tp) == jcfg.qkv_bias
    rng = np.random.default_rng(5)
    s = 21
    x = _both(rng.standard_normal((2, s, jcfg.d_model)))
    pos = np.tile(np.arange(s, dtype=np.int32), (2, 1))
    jy, (jk, jv) = jattn.attention(jp, jcfg, x[0], jnp.asarray(pos))
    ty, (tk, tv) = tattn.attention(tp, tcfg, x[1], torch.from_numpy(pos))
    for g, w in ((ty, jy), (tk, jk), (tv, jv)):
        assert_allclose(_np(g), _np(w), rtol=F32, atol=1e-4)
    smax = s + 4
    pad = [(0, 0), (0, smax - s), (0, 0), (0, 0)]
    jkc, jvc = jnp.pad(jk, pad), jnp.pad(jv, pad)
    tkc = torch.from_numpy(np.array(jkc))
    tvc = torch.from_numpy(np.array(jvc))
    x1 = _both(rng.standard_normal((2, 1, jcfg.d_model)))
    jo, jkc2, _ = jattn.decode_attention(jp, jcfg, x1[0], jkc, jvc,
                                         jnp.int32(s))
    to, tkc2, _ = tattn.decode_attention(tp, tcfg, x1[1], tkc, tvc, s)
    assert tkc2 is tkc                              # written in place
    assert_allclose(_np(to), _np(jo), rtol=F32, atol=1e-4)
    assert_allclose(_np(tkc), _np(jkc2), rtol=F32, atol=1e-4)


# -- the slice as a whole ----------------------------------------------------

@pytest.fixture(scope="module")
def served():
    """Per arch: JAX params, the port's LM built from them, and the JAX
    package's prefill, decode and generate results on one prompt batch."""
    cache = {}

    def get(arch):
        if arch in cache:
            return cache[arch]
        jcfg, tcfg = cfgs(arch)
        jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
        tp = interop.lm_params_from_numpy(tcfg, to_np(jp), device="cpu")
        rng = np.random.default_rng(1)
        toks = rng.integers(0, jcfg.vocab_size, (2, PROMPT), dtype=np.int32)
        jl, jc = jtfm.prefill(jp, jcfg, jnp.asarray(toks))
        out = np.asarray(JaxEngine(jcfg, jp, PROMPT + NEW).generate(
            jnp.asarray(toks), NEW))
        full, _ = jtfm.forward_train(jp, jcfg, jnp.asarray(out))
        cache[arch] = dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, toks=toks,
                           jl=jl, jc=jc, out=out, full=np.asarray(full))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_prefill_logits_and_cache_match_jax(served, arch):
    s = served(arch)
    tl, tc = ttfm.prefill(s["tp"], s["tcfg"], torch.from_numpy(s["toks"]))
    assert tl.shape == (2, s["tcfg"].padded_vocab)
    assert rel_err(tl, s["jl"], s["tcfg"].vocab_size) <= REL
    want = jax.tree.leaves(to_np(s["jc"]))
    got = jax.tree.leaves(cache_to_np(tc))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert_allclose(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_decode_step_logits_match_jax(served, arch):
    """The JAX prefill cache, grown to 40 positions, carried into the port;
    one decode step each."""
    s = served(arch)
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
    assert rel_err(tl, jl, tcfg.vocab_size) <= REL
    for g, w in zip(jax.tree.leaves(cache_to_np(tc2)),
                    jax.tree.leaves(to_np(jc2))):
        assert_allclose(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_generate_tokens_match_jax(served, arch):
    """Greedy tokens of a 37-token prompt and 8 new ones are equal.  At a
    step where the JAX top-2 margin is below the logits tolerance the
    token may differ; there the logits are compared instead, and the
    sequences are not compared past it."""
    s = served(arch)
    tcfg = s["tcfg"]
    got, logits = ServeEngine(tcfg, s["tp"], PROMPT + NEW).generate(
        torch.from_numpy(s["toks"]), NEW, return_logits=True)
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
        assert margin <= REL * np.abs(want_logits[..., :v]).max(), (arch, t)
        break


def test_bf16_prefill_within_archs_limit():
    """One bfloat16 case, held to tests/test_archs.py's 0.06 limit."""
    jcfg, tcfg = cfgs("zamba2_1_2b", "bfloat16")
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = interop.lm_params_from_numpy(tcfg, to_np(jp), device="cpu")
    assert tp["embed"]["embedding"].dtype == torch.bfloat16
    toks = np.random.default_rng(2).integers(0, 503, (2, 37), dtype=np.int32)
    jl, _ = jtfm.prefill(jp, jcfg, jnp.asarray(toks))
    tl, tc = ttfm.prefill(tp, tcfg, torch.from_numpy(toks))
    assert tl.dtype == torch.bfloat16
    assert tc["unit"][0]["0M"]["ssm"].dtype == torch.float32
    assert rel_err(tl, jl, 503) < REL_BF16


# -- structure, init and entry points ----------------------------------------

@pytest.mark.parametrize("arch", ["zamba2_1_2b", "mamba2_2_7b", "qwen3_8b",
                                  "qwen2_5_14b", "phi3_mini_3_8b",
                                  "chameleon_34b", "granite_moe_3b",
                                  "llama4_maverick_400b",
                                  "whisper_large_v3"])
def test_param_and_cache_specs_match_jax_at_full_size(arch):
    """Same names, shapes and dtypes as the JAX specs, without
    allocating: the full-size model and a serving cache."""
    jcfg, tcfg = get_config(arch), tconfigs.get_config(arch)

    def flat(tree, is_leaf):
        return {"/".join(str(getattr(k, "key", k)) for k in path):
                (tuple(s.shape), s.dtype)
                for path, s in jax.tree_util.tree_flatten_with_path(
                    tree, is_leaf=is_leaf)[0]}

    is_spec = lambda x: hasattr(x, "init") and hasattr(x, "axes")  # noqa
    for jspec, tspec in ((jtfm.param_specs(jcfg), ttfm.param_specs(tcfg)),
                         (jtfm.cache_specs(jcfg, 4, 2080),
                          ttfm.cache_specs(tcfg, 4, 2080))):
        want = flat(jspec, is_spec)
        got = {p.replace(".", "/"): (s.shape, s.dtype)
               for p, s in tparams.leaves(tspec)}
        assert got == want
    assert sum(np.prod(s) for s, _ in got.values()) > 0


def test_full_size_zamba2_counts():
    cfg = tconfigs.get_config("zamba2_1_2b")
    assert cfg.num_layers == 38 and cfg.num_units == 6
    n = sum(np.prod(s.shape)
            for _, s in tparams.leaves(ttfm.param_specs(cfg)))
    # param_count leaves out the norm weights: ln and the gated norm of
    # each M block, ln1 and ln2 of each A block, and the final norm.
    d, d_in = cfg.d_model, cfg.ssm.expand * cfg.d_model
    norms = 32 * (d + d_in) + 6 * 2 * d + d
    assert n == cfg.param_count() + norms
    assert 1.28e9 < n < 1.30e9


def test_full_size_granite_counts():
    cfg = tconfigs.get_config("granite_moe_3b")
    assert (cfg.num_layers, cfg.d_model, cfg.moe.num_experts,
            cfg.moe.top_k, cfg.moe.d_ff) == (32, 1536, 40, 8, 512)
    specs = ttfm.param_specs(cfg)
    n = sum(np.prod(s.shape) for _, s in tparams.leaves(specs))
    # param_count leaves out the norm weights: ln1 and ln2 of each E
    # block, and the final norm.
    assert n == cfg.param_count() + 32 * 2 * cfg.d_model + cfg.d_model
    assert 3.2e9 < n < 3.4e9
    assert specs["unit"]["0E"]["moe"]["wi_gate"].shape == (32, 40, 1536, 512)


def test_full_size_whisper_counts():
    """whisper_large_v3 from the specs: 32 encoder and 32 decoder layers;
    ``param_count`` approximates the cross attention, the specs do not."""
    cfg = tconfigs.get_config("whisper_large_v3")
    specs = ttfm.param_specs(cfg)
    n = sum(np.prod(s.shape) for _, s in tparams.leaves(specs))
    assert n == 2_020_682_240
    assert specs["encoder"]["unit"]["0D"]["attn"]["wq"].shape == \
        (32, 1280, 20, 64)
    assert specs["unit"]["0D"]["cross"]["wk"].shape == (32, 1280, 20, 64)
    assert set(specs["unit"]["0D"]) == {"ln1", "attn", "ln2", "mlp",
                                        "ln_cross", "cross"}
    assert set(specs["encoder"]["unit"]["0D"]) == {"ln1", "attn", "ln2",
                                                   "mlp"}
    cache = ttfm.cache_specs(cfg, 8, 36)["unit"]["0D"]
    assert cache["ck"].shape == (32, 8, 1500, 20, 64)
    assert cache["k"].shape == (32, 8, 36, 20, 64)


def test_unported_block_types_raise():
    cfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(
        "qwen3_8b")), pattern_unit="DX", num_layers=2)
    with pytest.raises(NotImplementedError, match="X"):
        ttfm.param_specs(cfg)
    with pytest.raises(NotImplementedError, match="X"):
        ttfm.init_params(cfg, torch.Generator().manual_seed(0))


def test_init_params_follows_jax_rules_and_seed():
    _, tcfg = cfgs("zamba2_1_2b")
    tcfg = dataclasses.replace(tcfg, num_layers=14)        # two units
    assert tcfg.num_units == 2
    a = ttfm.init_params(tcfg, torch.Generator().manual_seed(0))
    b = ttfm.init_params(tcfg, torch.Generator().manual_seed(0))
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    m = a.unit[0]["0M"]["mamba"]
    assert torch.equal(m["A_log"], torch.zeros(8))
    assert torch.equal(m["D"], torch.ones(8))
    assert a["final_norm"].dtype == torch.float32
    # Stacked unit weights count the layer axis in their fan-in, as JAX.
    std = a.unit[1]["5A"]["mlp"]["wi_gate"].std().item()
    assert std == pytest.approx(1 / np.sqrt(2 * 64), rel=0.1)
    tail = a.tail["0M"]["mamba"]["in_x"].std().item()
    assert tail == pytest.approx(1 / 8, rel=0.1)
    assert a["embed"]["embedding"].std().item() == pytest.approx(1, rel=0.1)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg = cfgs("zamba2_1_2b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttfm.init_params(tcfg)


def test_engine_checks_and_cache_roundtrip(served):
    s = served("zamba2_1_2b")
    eng = ServeEngine(s["tcfg"], s["tp"], max_seq=PROMPT)
    with pytest.raises(ValueError):
        eng.generate(torch.from_numpy(s["toks"]), 3)
    with pytest.raises(ValueError):
        eng.generate(torch.from_numpy(s["toks"]), 0)
    tree = to_np(s["jc"])
    back = cache_to_np(
        interop.lm_cache_from_numpy(s["tcfg"], tree, device="cpu"))
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert np.array_equal(g, w)


def test_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "zamba2_1_2b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "9", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "device=cpu (host clock) generated (2, 12)" in out
