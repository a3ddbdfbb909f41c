"""Port parity for the paper's §3.3 mechanisms: the scan allocator
(``core/allocator.py``), workload-divergence grouping
(``core/divergence.py``) and ``CoProcessor.run_map_series`` with its
boundary moves, against the JAX package on the same NumPy inputs.
Integer results are equal bit for bit; the float32 divergence waste is
held within 1e-6 relative, as its sums add in a different order."""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc

from _torch_parity import assert_same, relation

SIZE_CASES = [
    (0, 256, 256), (1, 256, 256), (255, 256, 256), (257, 64, 32),
    (5000, 256, 256), (5000, 128, 1), (4096, 1, 8), (1 << 14, 256, 1024)]


def _sizes(n: int, seed: int = 0) -> np.ndarray:
    """Request sizes with zeros (no claim) and a few large requests."""
    rng = np.random.default_rng(seed + n)
    s = rng.integers(0, 40, n).astype(np.int32)
    s[rng.random(n) < 0.2] = 0
    s[rng.random(n) < 0.01] = 5000
    return s


@pytest.mark.parametrize("n,tile,block", SIZE_CASES)
def test_scan_alloc_matches(n, tile, block):
    sizes = _sizes(n)
    want_offs, want_total = jc.scan_alloc(jnp.asarray(sizes), tile=tile,
                                          block_items=block)
    offs, total = tc.scan_alloc(torch.from_numpy(sizes), tile=tile,
                                block_items=block)
    assert offs.dtype == total.dtype == torch.int32
    assert np.array_equal(offs.numpy(), np.asarray(want_offs))
    assert int(total) == int(want_total)
    # Offsets do not overlap: each request's extent ends before the next
    # one in its tile starts, and tiles start block-aligned.
    o = offs.numpy().astype(np.int64)
    if n:
        ends = o + sizes
        assert (o[1:][np.arange(1, n) % tile != 0]
                == ends[:-1][np.arange(1, n) % tile != 0]).all()
        assert (o[::tile] % block == 0).all()
        assert ends.max() <= int(total)


@pytest.mark.parametrize("n,tile,block", SIZE_CASES)
def test_alloc_stats_and_basic_units_match(n, tile, block):
    sizes = _sizes(n, seed=1)
    for arg in (sizes, sizes.astype(np.int64), torch.from_numpy(sizes)):
        got = tc.alloc_stats(arg, tile=tile, block_items=block,
                             item_bytes=4)
        want = jc.alloc_stats(np.asarray(arg), tile=tile, block_items=block,
                              item_bytes=4)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert tc.basic_alloc_units(arg) == jc.basic_alloc_units(
            np.asarray(arg))
    assert ([(f.name, f.type) for f in dataclasses.fields(
        tc.allocator.AllocStats)] == [(f.name, f.type) for f in
                                      dataclasses.fields(
                                          jc.allocator.AllocStats)])


def test_scan_alloc_wraps_like_the_reference():
    """int32 sums wrap in both packages (sizes summing past 2^31)."""
    sizes = np.full(1024, 1 << 22, np.int32)
    want_offs, want_total = jc.scan_alloc(jnp.asarray(sizes), tile=256,
                                          block_items=256)
    offs, total = tc.scan_alloc(torch.from_numpy(sizes), tile=256,
                                block_items=256)
    assert np.array_equal(offs.numpy(), np.asarray(want_offs))
    assert int(total) == int(want_total)


def _workload(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.integers(0, 100, n).astype(np.int32)
    if kind == "skewed":      # p2 key counts of a skewed probe: mostly 0-2
        w = rng.poisson(1.0, n).astype(np.int32)
        w[rng.random(n) < 0.02] = 4096
        return w
    if kind == "zeros":
        return np.zeros(n, np.int32)
    return rng.random(n).astype(np.float32) * 50.0      # float work


@pytest.mark.parametrize("kind", ["uniform", "skewed", "zeros", "float"])
@pytest.mark.parametrize("groups", [1, 2, 64, 1000])
@pytest.mark.parametrize("n", [1, 300, 4096])
def test_divergence_order_and_inverse_match(kind, groups, n):
    w = _workload(kind, n, seed=n + groups)
    want = np.asarray(jc.divergence_order(jnp.asarray(w), groups))
    got = tc.divergence_order(torch.from_numpy(w), groups)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    inv = tc.inverse_permutation(got)
    assert np.array_equal(inv.numpy(), np.asarray(
        jc.inverse_permutation(jnp.asarray(want))))
    assert np.array_equal(got.numpy()[inv.numpy()], np.arange(n))


@pytest.mark.parametrize("kind", ["uniform", "skewed", "zeros", "float"])
@pytest.mark.parametrize("tile", [1, 32, 256])
@pytest.mark.parametrize("n", [0, 1, 300, 4096])
def test_tile_divergence_waste_matches(kind, tile, n):
    w = _workload(kind, n, seed=7 * n + tile)
    want = float(jc.tile_divergence_waste(jnp.asarray(w), tile))
    got = tc.tile_divergence_waste(torch.from_numpy(w), tile)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-7)
    if n and kind == "skewed":
        # Grouping by workload cuts the waste, as the paper's §3.3 says.
        order = tc.divergence_order(torch.from_numpy(w), 64).long()
        assert float(tc.tile_divergence_waste(
            torch.from_numpy(w)[order], tile)) <= float(got) + 1e-6


# ---------------------------------------------------------------------------
# run_map_series.
# ---------------------------------------------------------------------------
def _bound(apply, fixed, shared, items):
    return apply({**shared, **fixed}, items)


def bound_series(series, **fixed):
    """``series`` with its scalar shared state bound into each step.

    The JAX package's ``run_map_series`` places ``shared`` on the groups'
    devices, so a Python int there reaches its jitted step as a traced
    array, and ``partition_series``' digit width or the build series'
    bucket count cannot be traced (ROADMAP C).  Binding the scalars
    keeps the steps and the series the same in both packages."""
    return type(series)(series.name, tuple(
        dataclasses.replace(st, apply=functools.partial(_bound, st.apply,
                                                        fixed))
        for st in series.steps))


def _items(n: int, seed: int):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 20, n).astype(np.int32)
    rids = rng.permutation(n).astype(np.int32)
    return ({"rid": jnp.asarray(rids), "key": jnp.asarray(keys)},
            {"rid": torch.from_numpy(rids), "key": torch.from_numpy(keys)})


def _map_series_both(make_series, shared, ratios, discrete, n, seed,
                     shared_fn=None):
    jcp = jc.CoProcessor(discrete=discrete, link=jc.PCIE_LINK)
    tcp = tc.CoProcessor(c_device="cpu", g_device="cpu",
                         discrete=discrete, link=tc.PCIE_LINK)
    ji, ti = _items(n, seed)
    jsh, tsh = shared_fn() if shared_fn else (shared, shared)
    want = jcp.run_map_series(make_series(jc), jsh, ji, ratios)
    got = tcp.run_map_series(make_series(tc), tsh, ti, ratios)
    return want, got


def _same_items(w: dict, g: dict):
    assert sorted(w) == sorted(g)
    for k in w:
        assert g[k].dtype == torch.int32 or g[k].dtype == torch.bool, k
        assert np.array_equal(g[k].numpy(), np.asarray(w[k])), k


@pytest.mark.parametrize("discrete", [False, True], ids=["plain",
                                                           "discrete"])
@pytest.mark.parametrize("ratios", [(0.0, 0.5, 0.25), (1.0, 0.0, 0.5),
                                    (0.25, 0.25, 0.25), (0.5, 1.0, 0.0)])
def test_run_map_series_partition_matches(ratios, discrete):
    """``partition_series(0)`` at 2^14 with per-step ratios: equal items
    per group, equal ``part_hist`` and equal emulated bus bytes."""
    (jc_items, jg_items, jextra, jt), (tc_items, tg_items, textra, tt) = \
        _map_series_both(
            lambda core: bound_series(core.partition_series(0), shift=0,
                                      bits=6),
            {}, ratios, discrete, 1 << 14, seed=3)
    _same_items(jc_items, tc_items)
    _same_items(jg_items, tg_items)
    assert sorted(textra) == sorted(jextra) == ["part_hist"]
    assert np.array_equal(textra["part_hist"].numpy(),
                          np.asarray(jextra["part_hist"]))
    assert (tt.transfer_bytes, tt.transfer_s) == (jt.transfer_bytes,
                                                  jt.transfer_s)
    if ratios[0] != ratios[1]:
        assert tt.transfer_bytes > 0
    # One-device run_series over each group's final slice gives the same
    # items, and the combined histogram is the whole relation's.
    _, ti = _items(1 << 14, 3)
    cut = tc.CoProcessor(c_device="cpu", g_device="cpu")._cut(
        1 << 14, ratios[-1])
    series = tc.partition_series(0)
    for lo, hi, got in ((0, cut, tc_items), (cut, 1 << 14, tg_items)):
        want, _ = tc.steps.run_series(series, {"shift": 0, "bits": 6},
                                      {k: v[lo:hi] for k, v in ti.items()})
        for k in ("rid", "key"):
            assert torch.equal(got[k], want[k])
    _, whole = tc.steps.run_series(series, {"shift": 0, "bits": 6}, ti)
    assert torch.equal(textra["part_hist"], whole["part_hist"])


def test_run_map_series_takes_scalar_shared_state():
    """The port runs ``partition_series(0)`` with its shared scalars as
    given (they stay Python ints on both groups); the result equals the
    bound series'."""
    tcp = tc.CoProcessor(c_device="cpu", g_device="cpu")
    _, ti = _items(4096, 5)
    ratios = (0.0, 0.5, 0.25)
    a = tcp.run_map_series(tc.partition_series(0), {"shift": 6, "bits": 7},
                           ti, ratios)
    b = tcp.run_map_series(bound_series(tc.partition_series(0), shift=6,
                                        bits=7), {}, ti, ratios)
    for x, y in ((a[0], b[0]), (a[1], b[1]), (a[2], b[2])):
        assert sorted(x) == sorted(y)
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert a[3].transfer_bytes == b[3].transfer_bytes > 0


@pytest.mark.parametrize("ratios", [(0.25, 0.25, 0.25, 0.25),
                                    (0.0, 0.5, 0.5, 0.25)])
def test_run_map_series_shj_build_matches(ratios):
    """The SHJ build series at fractional ratios: the same per-group
    partial tables and the same combined bucket histogram."""
    nb = 1024
    (_, _, jextra, jt), (_, _, textra, tt) = _map_series_both(
        lambda core: bound_series(core.BUILD_SERIES, num_buckets=nb), {},
        ratios, False, 4096, seed=11)
    assert np.array_equal(textra["hist"].numpy(), np.asarray(jextra["hist"]))
    assert len(textra["partial_tables"]) == len(jextra["partial_tables"])
    for w, g in zip(jextra["partial_tables"], textra["partial_tables"]):
        assert_same(w, g)
    assert tt.transfer_bytes == jt.transfer_bytes


@pytest.mark.parametrize("ratios", [(0.25, 0.25, 0.25, 0.25),
                                    (0.0, 0.5, 0.5, 0.25)])
def test_run_map_series_shj_probe_matches(ratios):
    """The SHJ probe series against a built table at fractional ratios:
    equal per-group join results, whose union is the join."""
    rng = np.random.default_rng(12)
    bkeys = rng.integers(0, 2048, 2048)
    jb, tb = relation(bkeys)
    nb = 512
    jt_, tt_ = jc.build_hash_table(jb, nb), tc.build_hash_table(tb, nb)

    def shared():
        return {"table": jt_}, {"table": tt_}

    (_, _, jextra, jt), (_, _, textra, tt) = _map_series_both(
        lambda core: bound_series(core.PROBE_SERIES, max_out=4 * 4096),
        None, ratios, False, 4096, seed=13, shared_fn=shared)
    assert len(textra["results"]) == len(jextra["results"]) == 2
    for w, g in zip(jextra["results"], textra["results"]):
        assert_same(w, g)
    assert tt.transfer_bytes == jt.transfer_bytes
