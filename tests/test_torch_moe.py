"""The port's MoE layer (``repro_torch.layers.moe``) and its ``E`` blocks
against the JAX package on the CPU: the capacity and group arithmetic,
both dispatch engines on reduced granite_moe_3b (40 experts top-8 cut to
8 top-2) and llama4_maverick_400b (top-1, shared expert), and both
reduced models served under each engine.

The same NumPy inputs and weights go to both packages.  In float32 the
routing itself is held equal: the top-k indices, the weights, and each
engine's expert buffers (which tokens each expert's capacity kept, in
which slot).  In bfloat16 the two packages' router products may round a
near-tie apart, so there only outputs and logits are held, within
tests/test_archs.py's 0.06; a router with built ties is exact in any
dtype and holds the routing in bfloat16 too."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import repro_torch.configs as tconfigs
from repro.configs import get_config, reduced
from repro.layers import moe as jmoe
from repro.models import transformer as jtfm
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.core import interop
from repro_torch.layers import moe as tmoe
from repro_torch.models import params as tparams
from repro_torch.models import transformer as ttfm
from repro_torch.serve.engine import ServeEngine
from test_torch_lm import cache_to_np, rel_err, to_np

F32 = 3e-5
DENSE_SORTED = 2e-5     # tests/test_layers.py
AUX = 1e-5
REL_BF16 = 0.06         # tests/test_archs.py's limit for bfloat16
ARCHS = ["granite_moe_3b", "llama4_maverick_400b"]
ENGINES = ["dense", "sorted"]
PROMPT, NEW = 37, 6


def cfgs(arch, dtype="float32", impl="dense", **moe):
    """The reduced config in both packages, with ``moe`` fields replaced."""
    out = []
    for get, red in ((get_config, reduced),
                     (tconfigs.get_config, tconfigs.reduced)):
        c = red(get(arch))
        out.append(dataclasses.replace(
            c, dtype=dtype, moe_impl=impl,
            moe=dataclasses.replace(c.moe, **moe)))
    return tuple(out)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _both(a, dtype):
    a = np.asarray(a, np.float32)
    return (jnp.asarray(a, jnp.dtype(dtype)),
            torch.from_numpy(a).to(tparams.torch_dtype(dtype)))


# -- arithmetic ---------------------------------------------------------------

TOKENS = [1, 2, 3, 4, 7, 24, 37, 74, 100, 512, 924, 1000, 1015, 1024, 2000,
          2030, 4096, 8192, 8316, 65536]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("factor", [0.5, 1.25, 5.0, 128.0])
def test_capacity_and_group_len_match_jax(arch, factor):
    jm = dataclasses.replace(get_config(arch).moe, capacity_factor=factor)
    tm = dataclasses.replace(tconfigs.get_config(arch).moe,
                             capacity_factor=factor)
    for n in TOKENS:
        assert tmoe._capacity(n, tm) == jmoe._capacity(n, jm), n
        for pref in (1, 8, 32, 1024):
            assert tmoe._group_len(n, pref) == jmoe._group_len(n, pref)
    assert tmoe._group_len(8192, 1024) == 1024
    assert tmoe._group_len(8316, 1024) == 924


# -- the layer ---------------------------------------------------------------

# (B, S, moe overrides): one group per sequence at capacity 1.25; one
# group at 0.5 (drops); groups of 8 that straddle the two sequences.  And
# a router with built ties (test_built_ties_route_as_jax).
CASES = {"cap1.25": ((2, 24), {}),
         "cap0.5": ((2, 32), {"capacity_factor": 0.5,
                              "group_size": 1 << 20}),
         "groups": ((2, 12), {"group_size": 8})}
TIES = ((2, 24), {})


def layer_inputs(arch, case, dtype):
    """The configs, the layer's weights in both packages (NumPy normals
    scaled by fan-in, in ``dtype``) and x."""
    (b, s), moe = TIES if case == "ties" else CASES[case]
    jcfg, tcfg = cfgs(arch, dtype, **moe)
    rng = np.random.default_rng(11)
    specs = tmoe.moe_specs(tcfg)
    tree = {path: rng.standard_normal(spec.shape) / np.sqrt(
        np.prod(spec.shape[:-1])) for path, spec in tparams.leaves(specs)}
    x = rng.standard_normal((b, s, jcfg.d_model))
    if case == "ties":
        # Integer logits (exact in bfloat16 and float32 alike), so equal
        # logits are common, and two identical router columns.
        x = rng.integers(-1, 2, x.shape).astype(np.float32)
        router = rng.integers(-1, 2, (jcfg.d_model, jcfg.moe.num_experts))
        router[:, 5] = router[:, 1]
        tree["router"] = router / 8
    tree = {k: np.asarray(_both(v, dtype)[0], np.float32)
            for k, v in tree.items()}           # rounded to dtype
    jp = {}
    for path, v in tree.items():
        *outer, leaf = path.split(".")
        node = jp
        for k in outer:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(v, jnp.dtype(dtype))
    tp = ttfm.Params(interop._tensors_like(specs, to_np(jp), dtype, "cpu"))
    return jcfg, tcfg, jp, tp, _both(x, dtype)


def run_captured(monkeypatch, module, fn, params, cfg, x, *, jit=False):
    """``fn(params, cfg, x)``, with what its ``_route`` returned and the
    expert buffers its ``_experts_ffn`` received, as NumPy (the JAX
    package's under ``jax.jit``, which returns them too)."""
    seen = []
    route, ffn = module._route, module._experts_ffn

    def spy_route(*args):
        seen.append(route(*args))
        return seen[-1]

    def spy_ffn(params, expert_in):
        seen.append(expert_in)
        return ffn(params, expert_in)

    monkeypatch.setattr(module, "_route", spy_route)
    monkeypatch.setattr(module, "_experts_ffn", spy_ffn)
    if jit:
        out = jax.jit(lambda p, x: (fn(p, cfg, x), seen))(params, x)
    else:
        out = (fn(params, cfg, x), seen)
    monkeypatch.setattr(module, "_route", route)
    monkeypatch.setattr(module, "_experts_ffn", ffn)
    (y, aux), ((idx, w, probs), buf) = out
    return (y, aux, np.asarray(idx), _np(w), _np(probs), _np(buf))


def kept_pairs(expert_in, xg, idx):
    """(G, T, K) bool: which (token, slot) pairs an expert's buffer holds,
    read off the buffers (every row of x is distinct)."""
    g_, t_, k_ = idx.shape
    kept = np.zeros((g_, t_, k_), bool)
    for g in range(g_):
        for e in range(expert_in.shape[1]):
            rows = expert_in[g, e]
            for r in rows[np.any(rows != 0, axis=1)]:
                (t,) = np.flatnonzero((xg[g] == r).all(1))
                kept[g, t, idx[g, t] == e] = True
    return kept


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("impl", ENGINES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_jax_f32(monkeypatch, arch, impl, case):
    jcfg, tcfg, jp, tp, (jx, tx) = layer_inputs(arch, case, "float32")
    b, s, d = tx.shape
    m = tcfg.moe
    jfn = jmoe.moe_dense if impl == "dense" else jmoe.moe_sorted
    tfn = tmoe.moe_dense if impl == "dense" else tmoe.moe_sorted
    jy, jaux, ji, jw, jprobs, jbuf = run_captured(
        monkeypatch, jmoe, jfn, jp, jcfg, jx, jit=True)
    ty, taux, ti, tw, tprobs, tbuf = run_captured(
        monkeypatch, tmoe, tfn, tp, tcfg, tx)
    t = tmoe._group_len(b * s, m.group_size) if impl == "dense" else b * s
    assert ti.dtype == np.int32 and ti.shape == (b * s // t, t, m.top_k)
    assert np.array_equal(ti, ji)
    assert_allclose(tw, jw, rtol=F32, atol=F32)
    assert_allclose(tprobs, jprobs, rtol=F32, atol=1e-7)
    assert np.array_equal(tbuf, jbuf)
    xg = _np(tx).reshape(-1, t, d)
    kept = kept_pairs(tbuf, xg, ti)
    assert np.array_equal(kept, kept_pairs(jbuf, xg, ji))
    cap = tmoe._capacity(t, m)
    assert tbuf.shape == (b * s // t, m.num_experts, cap, d)
    if case == "cap0.5":
        assert not kept.all()                   # the case drops pairs
    assert ty.dtype == torch.float32 and taux.dtype == torch.float32
    assert_allclose(_np(ty), _np(jy), rtol=F32, atol=F32)
    assert float(taux) == pytest.approx(float(jaux), rel=AUX)


@pytest.mark.parametrize("impl", ENGINES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_jax_bf16(arch, impl):
    jcfg, tcfg, jp, tp, (jx, tx) = layer_inputs(arch, "cap1.25", "bfloat16")
    jfn = jmoe.moe_dense if impl == "dense" else jmoe.moe_sorted
    tfn = tmoe.moe_dense if impl == "dense" else tmoe.moe_sorted
    jy, jaux = jax.jit(jfn, static_argnums=1)(jp, jcfg, jx)
    ty, taux = tfn(tp, tcfg, tx)
    assert ty.dtype == torch.bfloat16 and taux.dtype == torch.float32
    assert np.abs(_np(ty) - _np(jy)).max() / np.abs(_np(jy)).max() < REL_BF16
    assert float(taux) == pytest.approx(float(jaux), rel=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ENGINES)
@pytest.mark.parametrize("arch", ARCHS)
def test_built_ties_route_as_jax(monkeypatch, arch, impl, dtype):
    """Exact ties resolve lowest expert first (``jax.lax.top_k``'s order;
    ``torch.topk`` breaks them otherwise), in bfloat16 too."""
    jcfg, tcfg, jp, tp, (jx, tx) = layer_inputs(arch, "ties", dtype)
    jfn = jmoe.moe_dense if impl == "dense" else jmoe.moe_sorted
    tfn = tmoe.moe_dense if impl == "dense" else tmoe.moe_sorted
    jy, _, ji, _, _, jbuf = run_captured(monkeypatch, jmoe, jfn, jp, jcfg,
                                         jx, jit=True)
    ty, _, ti, _, p, tbuf = run_captured(monkeypatch, tmoe, tfn, tp, tcfg,
                                         tx)
    assert np.array_equal(ti, ji) and np.array_equal(tbuf, jbuf)
    # The case holds ties: equal probabilities at a chosen and an unchosen
    # expert, or among the chosen.
    k = tcfg.moe.top_k
    top = np.take_along_axis(p, ti.astype(np.int64), -1)
    assert (np.sort(p, -1)[..., -k - 1] == top[..., -1]).any() or \
        (top[..., :-1] == top[..., 1:]).any()
    if dtype == "float32":
        assert_allclose(_np(ty), _np(jy), rtol=F32, atol=F32)
    else:
        assert np.abs(_np(ty) - _np(jy)).max() / np.abs(_np(jy)).max() \
            < REL_BF16


@pytest.mark.parametrize("arch", ARCHS)
def test_port_dense_equals_sorted(arch):
    """The two engines compute one function where neither drops (one
    group at capacity E / k), as tests/test_layers.py holds the JAX pair."""
    jcfg, tcfg, jp, tp, (_, tx) = layer_inputs(arch, "cap1.25", "float32")
    m = tcfg.moe
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))
    y1, a1 = tmoe.moe(tp, tcfg, tx)
    y2, a2 = tmoe.moe(tp, dataclasses.replace(tcfg, moe_impl="sorted"), tx)
    assert_allclose(_np(y1), _np(y2), atol=DENSE_SORTED)
    assert float(a1) == pytest.approx(float(a2), rel=AUX)


# -- the served models -------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    """Per (arch, dtype): seed-0 parameters of the reduced config, drawn by
    the init rules both packages share (``materialize``: float32 normals
    scaled by fan-in, rounded to the spec's dtype), as the JAX package's
    tree (``unit`` stacked)."""
    memo = {}

    def get(arch, dtype):
        if (arch, dtype) not in memo:
            jcfg, tcfg = cfgs(arch, dtype)
            tree = tparams.materialize(ttfm.param_specs(tcfg),
                                       torch.Generator().manual_seed(0),
                                       tcfg.dtype)
            memo[arch, dtype] = jax.tree.map(
                lambda spec, t: jnp.asarray(t.float().numpy(),
                                            jnp.dtype(spec.dtype or dtype)),
                jtfm.param_specs(jcfg), tree,
                is_leaf=lambda x: hasattr(x, "init"))
        return memo[arch, dtype]
    return get


@pytest.fixture(scope="module")
def served(jax_params):
    """Per (arch, engine): the port's LM holding the JAX parameters, and
    the JAX package's ``ServeEngine.generate`` tokens, the prefill
    (logits, cache) and the first decode step (inputs, outputs) it made,
    and forward_train over the tokens."""
    memo = {}

    def get(arch, impl):
        if (arch, impl) in memo:
            return memo[arch, impl]
        jcfg, tcfg = cfgs(arch, impl=impl)
        jp = jax_params(arch, "float32")
        tp = interop.lm_params_from_numpy(tcfg, to_np(jp), device="cpu")
        rng = np.random.default_rng(3)
        toks = rng.integers(0, jcfg.vocab_size, (2, PROMPT), dtype=np.int32)
        seen, steps = [], []
        prefill, jit = jax.jit(jtfm.prefill, static_argnums=1), jax.jit

        def spy_jit(fn):        # the engine's jitted decode step
            step = jit(fn)

            def call(*args):
                steps.append((args, step(*args)))
                return steps[-1][1]
            return call

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jtfm, "prefill",
                       lambda *a: seen.append(prefill(*a)) or seen[0])
            mp.setattr(jax, "jit", spy_jit)
            out = np.asarray(JaxEngine(jcfg, jp, PROMPT + NEW).generate(
                jnp.asarray(toks), NEW))
        (jl, jc), = seen
        assert len(steps) == NEW - 1
        full, aux = jax.jit(jtfm.forward_train, static_argnums=1)(
            jp, jcfg, jnp.asarray(out))
        memo[arch, impl] = dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp,
                                toks=toks, jl=jl, jc=jc, step=steps[0],
                                out=out,
                                full=np.asarray(full), aux=float(aux))
        return memo[arch, impl]
    return get


@pytest.mark.parametrize("impl", ENGINES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_jax(served, arch, impl):
    s = served(arch, impl)
    tl, tc = ttfm.prefill(s["tp"], s["tcfg"], torch.from_numpy(s["toks"]))
    assert rel_err(tl, s["jl"], s["tcfg"].vocab_size) <= F32
    want = jax.tree.leaves(to_np(s["jc"]))
    got = jax.tree.leaves(cache_to_np(tc))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_allclose(g, w, rtol=F32, atol=F32)


@pytest.mark.parametrize("impl", ENGINES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_logits_match_jax(served, arch, impl):
    """The JAX engine's first decode step (its prefill cache grown to 43
    positions) carried into the port, logits and caches compared; the
    step's MoE groups are the batch's 2 tokens."""
    s = served(arch, impl)
    tcfg = s["tcfg"]
    (_, jc, tok, n), (jl, jc2) = s["step"]
    assert int(n) == PROMPT
    tc = interop.lm_cache_from_numpy(tcfg, to_np(jc), device="cpu")
    tl, tc2 = ttfm.decode_step(s["tp"], tcfg, torch.from_numpy(
        np.array(tok)), tc, PROMPT)
    assert rel_err(tl, jl, tcfg.vocab_size) <= F32
    for g, w in zip(jax.tree.leaves(cache_to_np(tc2)),
                    jax.tree.leaves(to_np(jc2))):
        assert_allclose(g, w, rtol=F32, atol=F32)


@pytest.mark.parametrize("impl", ENGINES)
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_and_aux_match_jax(served, arch, impl):
    """Equal greedy tokens; the first new token's logits are the
    prefill's.  forward_train over the generated tokens (its groups, and
    so its drops, differ from decode's) gives JAX's logits and aux."""
    s = served(arch, impl)
    tcfg = s["tcfg"]
    got, logits = ServeEngine(tcfg, s["tp"], PROMPT + NEW).generate(
        torch.from_numpy(s["toks"]), NEW, return_logits=True)
    assert np.array_equal(got.numpy(), s["out"])
    assert logits.shape == (2, NEW, tcfg.padded_vocab)
    assert rel_err(logits[:, 0], s["jl"], tcfg.vocab_size) <= F32
    full, aux = ttfm.forward_train(s["tp"], tcfg, got)
    assert rel_err(full, s["full"], tcfg.vocab_size) <= F32
    assert aux.dtype == torch.float32 and float(aux) > 0
    assert float(aux) == pytest.approx(s["aux"], rel=AUX)


@pytest.mark.parametrize("impl", ENGINES)
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_within_archs_limit(jax_params, arch, impl):
    jcfg, tcfg = cfgs(arch, "bfloat16", impl=impl)
    jp = jax_params(arch, "bfloat16")
    tp = interop.lm_params_from_numpy(tcfg, to_np(jp), device="cpu")
    blk = tp.unit[0][f"{len(tcfg.pattern_unit) - 1}E"]["moe"]
    assert blk["wi_gate"].dtype == torch.bfloat16
    toks = np.random.default_rng(2).integers(0, 503, (2, 37), dtype=np.int32)
    jl, _ = jax.jit(jtfm.prefill, static_argnums=1)(jp, jcfg,
                                                    jnp.asarray(toks))
    tl, _ = ttfm.prefill(tp, tcfg, torch.from_numpy(toks))
    assert tl.dtype == torch.bfloat16
    assert rel_err(tl, jl, 503) < REL_BF16


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_expert_weights_carry_across(jax_params, arch):
    """lm_params_from_numpy takes a JAX tree of two units, expert weights
    stacked (L, E, d, f), and gives each unit its own (E, d, f) copy."""
    jcfg, tcfg = cfgs(arch)
    tcfg = dataclasses.replace(tcfg, num_layers=2 * tcfg.num_layers)
    one = to_np(jax_params(arch, "float32"))
    tree = dict(one, unit=jax.tree.map(
        lambda v: np.concatenate([v, 2 * v]), one["unit"]))
    key = f"{len(jcfg.pattern_unit) - 1}E"
    stacked = tree["unit"][key]["moe"]
    m = jcfg.moe
    assert stacked["wi_gate"].shape == (2, m.num_experts, jcfg.d_model,
                                        m.d_ff)
    tp = interop.lm_params_from_numpy(tcfg, tree, device="cpu")
    for i in range(2):
        got = tp.unit[i][key]["moe"]
        for name in ("router", "wi_gate", "wi_up", "wo"):
            assert np.array_equal(got[name].numpy(), stacked[name][i])
        assert ("shared" in got) == bool(m.shared_d_ff)


def test_serve_cli_runs_granite_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "granite_moe_3b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "9", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "arch=granite_moe_3b_smoke device=cpu (host clock) generated " \
        "(2, 12)" in out
