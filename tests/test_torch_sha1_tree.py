"""The tree SHA-1 content key of relations on the card
(``repro_torch.kernels.sha1_tree``, ``engine/table_cache.py``), on the
CPU: the plain tree against ``hashlib`` composed by hand from the format,
the keys' properties, and the service's host path.  The kernel against
the plain tree is in ``tests/test_torch_cuda.py``."""
import hashlib

import numpy as np
import pytest
import torch

import repro_torch.core as tc
import repro_torch.engine as te
from repro_torch.engine import table_cache
from repro_torch.kernels import launch_counts
from repro_torch.kernels.sha1_tree import sha1_tree as st
from repro_torch.obs.trace import Tracer

# Elements of an int32 column: empty, one, a leaf less one, a leaf, a leaf
# and one, the most leaves with no node level (64 of 256 words) less one,
# that, one more (the first node level), 2^16 + 3, and a second node level.
SIZES = (0, 1, 255, 256, 257, 64 * 256 - 1, 64 * 256, 64 * 256 + 1,
         2**16 + 3, 64 * 64 * 256 + 5)


def _by_hand(data: bytes) -> tuple[bytes, int]:
    """The tree as the format states it, in ``hashlib`` alone: leaves of
    1024 bytes, nodes of 64 digests and the byte 0x01, until at most 64
    digests remain.  Returns the top digests and the SHA-1 blocks
    hashed."""
    msgs = [data[i:i + 1024] for i in range(0, len(data), 1024)] or [b""]
    blocks = sum((len(m) + 8) // 64 + 1 for m in msgs)
    level = [hashlib.sha1(m).digest() for m in msgs]
    while len(level) > 64:
        msgs = [b"".join(level[i:i + 64]) + b"\x01"
                for i in range(0, len(level), 64)]
        blocks += sum((len(m) + 8) // 64 + 1 for m in msgs)
        level = [hashlib.sha1(m).digest() for m in msgs]
    return b"".join(level), blocks


def _col(n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-2**31, 2**31 - 1, n)
                            .astype(np.int32))


def _rel(n: int = 3000, seed: int = 0) -> tc.Relation:
    return tc.Relation(torch.arange(n, dtype=torch.int32), _col(n, seed))


@pytest.mark.parametrize("n", SIZES)
def test_plain_tree_equals_hashlib_by_hand(n):
    key, rid = _col(n, n), torch.arange(n, dtype=torch.int32)
    want_key, blocks = _by_hand(key.numpy().tobytes())
    want_rid, _ = _by_hand(rid.numpy().tobytes())
    assert st.tree_tops_plain([key]).numpy().tobytes() == want_key
    got = st.tree_tops([key, rid])           # CPU tensors: the plain tree
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert got.numpy().tobytes() == want_key + want_rid
    assert st.top_nbytes(key.nbytes) == len(want_key)
    assert len(want_key) == 20 * st.level_sizes(key.nbytes)[-1] <= 20 * 64
    assert st.tree_ops(key.nbytes) == blocks * st.OPS_PER_BLOCK
    # The digest is of the bytes: a view 4 bytes into a larger column.
    wide = torch.cat([torch.tensor([7], dtype=torch.int32), key])
    assert st.tree_tops_plain([wide[1:]]).numpy().tobytes() == want_key


def _variant(change: str, rel: tc.Relation):
    """``(relation, num_buckets)`` after ``change`` to ``(rel, 64)``."""
    key, rid = rel.key.clone(), rel.rid.clone()
    if change == "fresh_tensors":
        return tc.Relation(rid, key), 64
    if change == "one_key_word":
        key[1234] ^= 1
    elif change == "two_rids_swapped":
        rid[[5, 2900]] = rid[[2900, 5]]
    elif change == "another_n":
        key, rid = key[:-1].clone(), rid[:-1].clone()
    elif change == "another_num_buckets":
        return tc.Relation(rid, key), 128
    else:
        raise ValueError(change)
    return tc.Relation(rid, key), 64


@pytest.mark.parametrize("change", ["fresh_tensors", "one_key_word",
                                    "two_rids_swapped", "another_n",
                                    "another_num_buckets"])
def test_tree_key_follows_the_content(change):
    rel = _rel()
    base = table_cache.tree_fingerprint(rel, 64)
    other, nb = _variant(change, rel)
    got = table_cache.tree_fingerprint(other, nb)
    assert (got == base) == (change == "fresh_tensors")
    # The host key tells the same pairs apart.
    assert (table_cache.host_fingerprint(other, nb)
            == table_cache.host_fingerprint(rel, 64)) == \
        (change == "fresh_tensors")


@pytest.mark.parametrize("n", [0, 1, 3000])
def test_tree_key_never_equals_the_host_key(n):
    rel = _rel(n)
    tree = table_cache.tree_fingerprint(rel, 0)
    flat = table_cache.host_fingerprint(rel, 0)
    assert tree.startswith(table_cache.TREE_TAG) and tree != flat
    assert len(flat) == 40 and not flat.startswith(table_cache.TREE_TAG)
    # A host relation keeps the reference's key, on the host path.
    fp = table_cache.content_fingerprint(rel, 0)
    assert fp == (flat, "host", rel.nbytes)
    assert te.relation_fingerprint(rel, 0) == flat
    # The tree key's own composition: SHA-1 of the top digests, key then
    # rid, and the host key's suffix.
    top = (_by_hand(rel.key.numpy().tobytes())[0]
           + _by_hand(rel.rid.numpy().tobytes())[0])
    assert tree == "t1:" + hashlib.sha1(top + f"|n={n}|b=0".encode()) \
        .hexdigest()


def test_tree_key_spans_hash_pull_hash():
    tr = Tracer()
    rel = _rel()
    assert table_cache.tree_fingerprint(rel, 8, tracer=tr) == \
        table_cache.tree_fingerprint(rel, 8)
    assert [s.name for s in tr.spans()] == ["fingerprint.hash",
                                            "fingerprint.pull",
                                            "fingerprint.hash"]


@pytest.mark.parametrize("bad,err", [
    (lambda: torch.arange(4, dtype=torch.int32), TypeError),
    (lambda: [torch.arange(4, dtype=torch.int32)] * 3, ValueError),
    (lambda: [torch.zeros((2, 2), dtype=torch.int32)], ValueError),
    (lambda: [torch.zeros(3, dtype=torch.int16)], ValueError)])
def test_tree_tops_rejects_bad_inputs(bad, err):
    with pytest.raises(err):
        st.tree_tops(bad())


def test_host_service_fingerprints_on_the_host_path():
    """A CPU service: every memo-missed ``fingerprint`` span says
    ``path="host"``, the ``fingerprints`` counter counts them, the ledger
    the columns' bytes, and no kernel launches."""
    svc = te.JoinQueryService(
        cp=tc.CoProcessor(c_device="cpu", g_device="cpu"), num_workers=0)
    r, s = _rel(4096, 1), _rel(4096, 2)
    before = launch_counts()["sha1_tree"]
    for i in range(2):
        out = svc.execute(te.JoinQuery(r, s, query_id=i))
        assert np.array_equal(out.result.valid_pairs(), tc.join_oracle(r, s))
    spans = [x for x in svc.tracer.spans() if x.name == "fingerprint"]
    missed = [x for x in spans if x.attrs["memo"] == "miss"]
    assert missed and all(x.attrs["path"] == "host" for x in missed)
    assert all("path" not in x.attrs for x in spans if x not in missed)
    assert svc.metrics.counter_series("fingerprints") == {
        (("path", "host"),): len(missed)}
    nbytes = {"build": r.nbytes, "probe": s.nbytes}
    assert svc.ledger.by_cause()["fingerprint"] == \
        sum(nbytes[x.attrs["side"]] for x in missed)
    assert launch_counts()["sha1_tree"] == before
    svc.close()
