"""The port's Hopper kernels and main path on a CUDA card, against their
plain versions and the CPU path, bit for bit.  Skips without a card; on
one, run ``python -m pytest -q -m cuda tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core import interop
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.partition_hist import fused, reorder

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's Hopper kernels)")
    return torch.device("cuda:0")


@pytest.mark.parametrize("n", [1, 31, 33, 4097, 100_003])
@pytest.mark.parametrize("shift,bits", [(0, 1), (7, 6), (3, 13), (9, 14),
                                        (16, 16)])
def test_kernels_match_plain_versions(dev, n, shift, bits):
    rng = np.random.default_rng(n + bits)
    keys = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, n)
                            .astype(np.int32)).to(dev)
    rid = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
    pid, hist = fused.partition_hist_fused(keys, shift=shift, bits=bits)
    ppid, phist = fused.partition_hist_fused_plain(keys, shift=shift,
                                                   bits=bits)
    assert torch.equal(pid, ppid) and torch.equal(hist, phist)
    starts = torch.cumsum(hist, 0, dtype=torch.int32) - hist
    got = reorder.radix_scatter(rid, keys, pid, starts, num_parts=1 << bits)
    want = reorder.radix_scatter_plain(rid, keys, ppid)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_wrappers_reject_bad_inputs(dev):
    keys64 = torch.zeros(64, dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        fused.partition_hist_fused(keys64, shift=0, bits=4)
    strided = torch.zeros(128, dtype=torch.int32, device=dev)[::2]
    with pytest.raises(ValueError):
        fused.partition_hist_fused(strided, shift=0, bits=4)
    k = torch.zeros(64, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        reorder.radix_scatter(k, k, k, k[:8], num_parts=16)


@pytest.mark.parametrize("kind", ["uniform", "high_skew"])
def test_phj_join_on_card_equals_cpu(dev, kind):
    n = 1 << 15
    gen = (tc.uniform_relation if kind == "uniform" else
           lambda m, seed, device: tc.skewed_relation(
               m, s_percent=25, seed=seed, device=device))
    b, p = gen(n, seed=1, device="cpu"), gen(n, seed=2, device="cpu")
    mo = 2 * n + len(tc.join_oracle(b, p))
    want = tc.phj_join(b, p, max_out=mo)
    reset_launch_counts()
    got = tc.phj_join(b.to(dev), p.to(dev), max_out=mo)
    passes = len(tc.resolve_schedule(n))
    assert launch_counts() == {"partition_hist_fused": 2 * passes,
                               "radix_scatter": 2 * passes}
    for w, g in zip(interop.to_numpy(want), interop.to_numpy(got)):
        assert np.array_equal(w, g)


def test_coprocessor_dd_on_card_equals_cpu(dev):
    n = 1 << 14
    b = tc.uniform_relation(n, seed=1, device="cpu")
    p = tc.uniform_relation(n, seed=2, device="cpu")
    kw = dict(shj_bits=2, max_out=3 * n, partition_ratio=0.25,
              join_ratio=0.4)
    want, _ = tc.CoProcessor("cpu", "cpu").phj(b, p, **kw)
    got, t = tc.CoProcessor("cpu", dev).phj(b.to(dev), p.to(dev), **kw)
    for w, g in zip(interop.to_numpy(want), interop.to_numpy(got)):
        assert np.array_equal(w, g)
    assert t.phase_s["partition"] > 0 and t.phase_s["join"] > 0
