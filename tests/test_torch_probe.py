"""Port parity for kernel F's path: ``build_partitioned_table``, the
partitioned probe's plain version and its oracle (repro_torch) against
``repro.kernels.probe`` (the Pallas kernel in interpret mode and its jnp
reference) on the same NumPy data, bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
from repro.kernels.probe import ops as jops
from repro.kernels.probe.probe import probe_pallas
from repro.kernels.probe.ref import probe_ref as j_probe_ref
from repro_torch.kernels.probe import ops as tops
from repro_torch.kernels.probe import probe as tprobe
from repro_torch.kernels.probe.ref import probe_ref, random_layout

from _torch_parity import relation

INT_MAX = 2**31 - 1


def _relations(nb, np_, kind, seed):
    """Build and probe sides from NumPy keys, in both packages."""
    rng = np.random.default_rng(seed)
    if kind == "unique":
        bkeys = rng.permutation(nb)
    elif kind == "duplicates":
        bkeys = rng.integers(0, nb // 8, nb)
    else:  # negative real keys on both sides
        bkeys = rng.integers(-nb, nb, nb)
    pkeys = rng.integers(-nb // 2, 3 * nb // 2, np_)
    return relation(bkeys), relation(pkeys)


LAYOUTS = [(512, 1024, 2, "unique"), (2048, 4096, 3, "unique"),
           (2048, 4096, 3, "duplicates"), (1024, 2048, 4, "negative")]


def _both_layouts(nb, np_, bits, kind):
    (jb, tb), (jp, tp) = _relations(nb, np_, kind, seed=nb + bits)
    want = jops.build_partitioned_table(jb, jp, total_bits=bits)
    got = tops.build_partitioned_table(tb, tp, total_bits=bits)
    return want, got


def _same(w, g):
    w = np.asarray(w)
    g = g.numpy()
    assert w.shape == g.shape and g.dtype == np.int32, (w.shape, g.shape)
    assert np.array_equal(w, g)


@pytest.mark.parametrize("nb,np_,bits,kind", LAYOUTS)
def test_build_partitioned_table_matches(nb, np_, bits, kind):
    want, got = _both_layouts(nb, np_, bits, kind)
    for w, g in zip(want, got):
        _same(w, g)
    tk, _, qk, _ = got
    assert tk.shape[0] == qk.shape[0] == 1 << bits
    assert tk.shape[1] % 128 == 0 and qk.shape[1] % 128 == 0


@pytest.mark.parametrize("nb,np_,bits,kind", LAYOUTS)
def test_probe_plain_matches_pallas_and_refs(nb, np_, bits, kind):
    (tk, tr, qk, _), got_layout = _both_layouts(nb, np_, bits, kind)
    got = tprobe.probe_plain(*got_layout[:3])
    _same(probe_pallas(tk, tr, qk, interpret=True), got)
    _same(j_probe_ref(tk, tr, qk), got)
    assert torch.equal(probe_ref(*got_layout[:3]), got)
    assert torch.equal(tops.probe(*got_layout[:3]), got)


def _hand_rows():
    """Rows sorted as uint32 with duplicates, a real INT_MAX key, negative
    real keys (after INT_MAX as uint32) and INT_MAX pads; probe keys with
    misses, -1 pads and negative keys."""
    rows = [[0, 5, 5, 7, INT_MAX, INT_MAX, INT_MAX, INT_MAX],
            [3, INT_MAX, -9, -9, -2, INT_MAX, INT_MAX, INT_MAX],
            [-5, -5, -5, -5, -5, -5, -5, -1],
            [INT_MAX] * 8]
    tk = np.array([sorted(r, key=lambda x: x & 0xFFFFFFFF) for r in rows],
                  np.int32)
    tr = np.arange(tk.size, dtype=np.int32).reshape(tk.shape)
    tr[3] = -1
    qk = np.array([[5, 7, 6, -1, 0, INT_MAX, 8, -1],
                   [INT_MAX, -9, -2, 3, 4, -1, 0, -3],
                   [-5, -1, 0, 5, -6, INT_MAX, -1, -1],
                   [0, INT_MAX, -1, 1, 2, 3, 4, 5]], np.int32)
    return tk, tr, qk


@pytest.mark.parametrize("case", ["hand", "random", "unsorted", "k1"])
def test_probe_plain_on_edge_rows(case):
    if case == "hand":
        tk, tr, qk = _hand_rows()
    else:
        k, m = (1, 8) if case == "k1" else (24, 40)
        tk, tr, qk = (t.numpy() for t in random_layout(5, k, m, seed=k))
        if case == "unsorted":
            tk = tk[:, np.random.default_rng(1).permutation(k)]
    got = tprobe.probe_plain(*(torch.from_numpy(a) for a in (tk, tr, qk)))
    _same(probe_pallas(jnp.asarray(tk), jnp.asarray(tr), jnp.asarray(qk),
                       interpret=True), got)
    if case != "unsorted":   # searchsorted needs sorted rows
        _same(j_probe_ref(jnp.asarray(tk), jnp.asarray(tr),
                          jnp.asarray(qk)), got)
        assert torch.equal(probe_ref(*(torch.from_numpy(a)
                                       for a in (tk, tr, qk))), got)
    if case == "hand":
        # Leftmost of the duplicate 5s; a real INT_MAX key is found before
        # the pads; negative probe keys never match.
        assert got[0, :3].tolist() == [1, 3, -1]
        assert got[1, :4].tolist() == [9, -1, -1, 8]
        assert got[2].tolist() == [-1] * 8


def test_end_to_end_join_with_partitioned_probe():
    """Port of ``test_kernel_end_to_end_join_with_pallas_probe``: the
    probe's (probe rid, match rid >= 0) pairs equal the join oracle."""
    jb = jc.unique_relation(4096, seed=42)
    jp = jc.uniform_relation(8192, key_range=6000, seed=43)
    tb = tc.unique_relation(4096, seed=42, device="cpu")
    tp = tc.uniform_relation(8192, key_range=6000, seed=43, device="cpu")
    tk, tr, qk, qr = tops.build_partitioned_table(tb, tp, total_bits=4)
    rid = tops.probe(tk, tr, qk)
    jtk, jtr, jqk, _ = jops.build_partitioned_table(jb, jp, total_bits=4)
    _same(jops.probe(jtk, jtr, jqk, interpret=True), rid)
    got = np.stack([qr.numpy().ravel(), rid.numpy().ravel()], 1)
    got = got[got[:, 1] >= 0]
    got = got[np.lexsort((got[:, 1], got[:, 0]))]
    exp = tc.join_oracle(tb, tp)
    assert got.shape == exp.shape and (got == exp).all()
    assert np.array_equal(exp, jc.join_oracle(jb, jp))


def test_probe_rejects_bad_layouts():
    tk = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        tprobe.probe(tk, tk[:, :4], tk)
    with pytest.raises(ValueError):
        tprobe.probe(tk, tk, tk[:2])
    with pytest.raises(ValueError):
        tprobe.probe(tk[:, :0], tk[:, :0], tk)
    with pytest.raises(ValueError):
        tprobe.probe(tk[0], tk[0], tk[0])
    b = tc.unique_relation(64, seed=1, device="cpu")
    with pytest.raises(ValueError):
        tops.build_partitioned_table(b, b, total_bits=-1)


def test_wide_layout_and_probe_match():
    """total_bits = 17 (2^17 partitions, past the old 2^16 cap): the
    layout equals the JAX package's, the probe its jnp reference, and the
    matches the join oracle."""
    (jb, tb), (jp, tp) = _relations(1024, 2048, "duplicates", seed=17)
    want = jops.build_partitioned_table(jb, jp, total_bits=17)
    got = tops.build_partitioned_table(tb, tp, total_bits=17)
    for w, g in zip(want, got):
        _same(w, g)
    rid = tops.probe(*got[:3])
    _same(j_probe_ref(*want[:3]), rid)
    pairs = np.stack([got[3].numpy().ravel(), rid.numpy().ravel()], 1)
    pairs = pairs[pairs[:, 1] >= 0]
    pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    # Each probe tuple finds the leftmost of its key's duplicates.
    exp = tc.join_oracle(tb, tp)
    first = exp[np.r_[True, exp[1:, 0] != exp[:-1, 0]]]
    assert np.array_equal(pairs, first)


def test_probe_layout_of_empty_sides():
    """Empty relations pack into the minimum caps (8 rounded up to 128)
    and probe to an all -1 result."""
    e = tc.Relation(torch.zeros(0, dtype=torch.int32),
                    torch.zeros(0, dtype=torch.int32))
    tk, tr, qk, qr = tops.build_partitioned_table(e, e, total_bits=2)
    assert tk.shape == qk.shape == (4, 128)
    assert (tk == INT_MAX).all() and (tr == -1).all() and (qk == -1).all()
    assert (tops.probe(tk, tr, qk) == -1).all()
