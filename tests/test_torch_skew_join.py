"""Zipf-keyed foreign-key joins through ``JoinQueryService`` on the CPU,
the benchmark's ``phj_zipf_16m`` deployment at test size: a unique-key
relation P and a Zipf 1.0 relation F over P's keys, joined with either
one built.  Each answer equals bench's plain reference pair for pair,
and the CSR expand's counts on the ``join.expand`` spans equal those of
the reference's match counts."""
import pytest
import torch

from bench.data.zipf_keys import make_relation_exact
from bench.reference.join import join_pairs, pair_codes, wrong_pairs
from repro_torch.core.coprocess import CoProcessor
from repro_torch.core.relation import Relation
from repro_torch.engine import JoinQuery, JoinQueryService, QueryPlanner
from repro_torch.kernels.csr_probe import EXPAND_COUNTERS, HEAVY, SPLIT


def _relations(n: int, seed: int) -> dict:
    specs = {"primary": {"rows": n, "keys": {"dist": "unique"}},
             "foreign": {"rows": n, "keys": {"dist": "zipf", "range": n,
                                             "s": 1.0}}}
    return {role: make_relation_exact(spec, "cpu", seed, "pool", 0, role)
            for role, spec in specs.items()}


def _reference_counts(codes: torch.Tensor, n: int) -> list[int]:
    """EXPAND_COUNTERS of the reference's answer: its pairs, those of
    probe tuples with more than ``HEAVY`` matches, the most matches, and
    those of probe tuples with more than ``SPLIT``."""
    m = torch.bincount(codes >> 32, minlength=n)
    return [int(m.sum()), int(m[m > HEAVY].sum()), int(m.max()),
            int(m[m > SPLIT].sum())]


@pytest.mark.parametrize("n", [1 << 12, 1 << 14])
@pytest.mark.parametrize("built", ["primary", "foreign"])
def test_zipf_join_through_the_service_matches_the_reference(built, n):
    rel = _relations(n, seed=2**31 + 7)
    probed = "foreign" if built == "primary" else "primary"
    (br, bk), (pr, pk) = rel[built], rel[probed]
    want = join_pairs(br, bk, pr, pk)
    assert want.shape[0] == n                    # each F tuple meets one P
    counts = _reference_counts(want, n)
    if built == "primary":
        assert counts[1:] == [0, 1, 0]
    else:
        assert counts[1] > n // 2 and counts[2] > n // 16
    # A PHJ overhead below zero makes the planner pick PHJ at this size,
    # as calibration does for the cells' 2^24.
    svc = JoinQueryService(cp=CoProcessor(c_device="cpu", g_device="cpu"),
                           planner=QueryPlanner(phj_overhead_s=-1.0))
    try:
        for _ in range(2):                       # cold, then layouts cached
            out = svc.submit(JoinQuery(Relation(br, bk), Relation(pr, pk)))()
            assert out.plan.algorithm == "phj"
            c = int(out.result.count)
            got = pair_codes(out.result.probe_rid[:c],
                             out.result.build_rid[:c])
            assert wrong_pairs(got, want) == 0
            expands = [s["attrs"] for s in out.trace
                       if s["name"] == "join.expand"]
            assert expands
            pairs, heavy, longest, split = EXPAND_COUNTERS
            assert [sum(a[pairs] for a in expands),
                    sum(a[heavy] for a in expands),
                    max(a[longest] for a in expands),
                    sum(a[split] for a in expands)] == counts
    finally:
        svc.close()
