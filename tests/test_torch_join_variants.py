"""Port parity for the join variants: ``probe_hash_table_variant``,
``probe_table_variant`` and ``join_variant_oracle`` (repro_torch.ops)
against ``repro.ops`` on the same data, whole padded ``JoinResult`` bit
for bit, and against the variant oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import repro.ops as jops
import repro_torch.core as tc
import repro_torch.ops as tops
from repro.core.hash_table import build_hash_table as j_build
from repro.core.hash_table import default_num_buckets

from _torch_parity import assert_same, to_torch


@pytest.fixture(scope="module")
def coprocessors():
    return jc.CoProcessor(), tc.CoProcessor(c_device="cpu", g_device="cpu")


def _selective(sel):
    jb = jc.unique_relation(512, seed=41)
    jp = jc.probe_with_selectivity(jb, 1024, selectivity=sel, seed=42)
    return jb, jp, to_torch(jb), to_torch(jp)


def _tables(jb, tb, num_buckets):
    return (j_build(jb, num_buckets),
            tc.build_hash_table(tb, num_buckets))


def test_join_kinds_and_null_rid():
    assert tops.JOIN_KINDS == jops.JOIN_KINDS
    assert tops.NULL_RID == jops.join_variants.NULL_RID == -1


@pytest.mark.parametrize("kind", ["inner", "semi", "anti", "left_outer"])
@pytest.mark.parametrize("sel", [0.0, 0.5, 1.0])
def test_probe_hash_table_variant_matches(kind, sel):
    jb, jp, tb, tp = _selective(sel)
    jt, tt = _tables(jb, tb, default_num_buckets(512))
    want = jops.probe_hash_table_variant(jp, jt, 4096, kind)
    got = tops.probe_hash_table_variant(tp, tt, 4096, kind)
    assert_same(want, got)
    exp = tops.join_variant_oracle(tb, tp, kind)
    assert np.array_equal(exp, jops.join_variant_oracle(jb, jp, kind))
    assert np.array_equal(got.valid_pairs(), exp)


@pytest.mark.parametrize("kind", ["semi", "anti", "left_outer"])
@pytest.mark.parametrize("ratio", [0.0, 0.5, 1.0])
def test_probe_table_variant_matches(coprocessors, kind, ratio):
    jcp, tcp_ = coprocessors
    jb, jp, tb, tp = _selective(0.5)
    jt, tt = _tables(jb, tb, default_num_buckets(512))
    want, wt = jops.probe_table_variant(jcp, jp, jt, kind=kind,
                                        max_out=4096, ratios=(ratio,) * 4)
    got, t = tops.probe_table_variant(tcp_, tp, tt, kind=kind, max_out=4096,
                                      ratios=(ratio,) * 4)
    assert_same(want, got)
    assert np.array_equal(got.valid_pairs(),
                          tops.join_variant_oracle(tb, tp, kind))
    assert t.transfer_bytes == wt.transfer_bytes
    assert set(t.phase_s) == {"probe"}


def test_probe_table_variant_truncates_like_reference(coprocessors):
    """A max_out below the outer join's row count, split across groups."""
    jcp, tcp_ = coprocessors
    jb, jp, tb, tp = _selective(0.5)
    jt, tt = _tables(jb, tb, 64)
    for kind in ("semi", "anti", "left_outer"):
        want, _ = jops.probe_table_variant(jcp, jp, jt, kind=kind,
                                           max_out=300, ratios=(0.5,) * 4)
        got, _ = tops.probe_table_variant(tcp_, tp, tt, kind=kind,
                                          max_out=300, ratios=(0.5,) * 4)
        assert_same(want, got)


def test_probe_variant_duplicate_keys():
    """Duplicate build keys: semi must not multiply rows, outer must
    (``tests/test_ops.py``'s case)."""
    jb = jc.uniform_relation(512, key_range=64, seed=5)
    jp = jc.uniform_relation(512, key_range=128, seed=6)
    tb, tp = to_torch(jb), to_torch(jp)
    jt, tt = _tables(jb, tb, default_num_buckets(512))
    for kind in ("semi", "anti", "left_outer"):
        want = jops.probe_hash_table_variant(jp, jt, 16384, kind)
        got = tops.probe_hash_table_variant(tp, tt, 16384, kind)
        assert_same(want, got)
        exp = tops.join_variant_oracle(tb, tp, kind)
        assert np.array_equal(exp, jops.join_variant_oracle(jb, jp, kind))
        assert np.array_equal(got.valid_pairs(), exp), kind
    n_semi = tops.join_variant_oracle(tb, tp, "semi").shape[0]
    n_anti = tops.join_variant_oracle(tb, tp, "anti").shape[0]
    assert n_semi + n_anti == 512
    assert tops.join_variant_oracle(tb, tp, "left_outer").shape[0] >= 512


def test_pad_rows_are_never_emitted():
    """Probe pads (rid -1, key -3) count neither as matched nor as
    unmatched."""
    jb = jc.unique_relation(256, seed=3)
    keys = np.asarray(jc.uniform_relation(256, key_range=400, seed=4).key)
    rid = np.arange(256, dtype=np.int32)
    rid[200:] = -1
    keys = keys.copy()
    keys[200:] = -3
    jp = jc.Relation(jnp.asarray(rid), jnp.asarray(keys))
    tb, tp = to_torch(jb), to_torch(jp)
    jt, tt = _tables(jb, tb, 128)
    for kind in ("semi", "anti", "left_outer"):
        want = jops.probe_hash_table_variant(jp, jt, 1024, kind)
        got = tops.probe_hash_table_variant(tp, tt, 1024, kind)
        assert_same(want, got)
        assert (got.probe_rid[:int(got.count)] >= 0).all()


def test_empty_probe_and_bad_kind():
    b = tc.unique_relation(64, seed=1, device="cpu")
    t = tc.build_hash_table(b, 16)
    e = tc.Relation(torch.zeros(0, dtype=torch.int32),
                    torch.zeros(0, dtype=torch.int32))
    for kind in ("semi", "anti", "left_outer"):
        res = tops.probe_hash_table_variant(e, t, 32, kind)
        assert int(res.count) == 0
        assert (res.probe_rid == -1).all() and (res.build_rid == -1).all()
    with pytest.raises(ValueError):
        tops.probe_hash_table_variant(b, t, 32, "full_outer")
    with pytest.raises(ValueError):
        tops.probe_table_variant(tc.CoProcessor("cpu", "cpu"), b, t,
                                 kind="cross", max_out=32, ratios=(0.0,) * 4)
