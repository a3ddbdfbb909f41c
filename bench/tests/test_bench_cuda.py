"""On the card: the profiler's kernel names and the program's launch
counters agree with the launch model that ``kernels.phj_roofline`` reads,
and a small run of every cell is correct.  Run on a CUDA machine with
``python -m pytest -q -m cuda bench/tests``; they skip without a card."""
from collections import Counter

import pytest
import torch

from bench import roofline as rl
from bench.data.relations import make_relation
from bench.reference.join import join_pairs, pair_codes, wrong_pairs
from bench.tests import _tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", [(7, 6), (13,)])
def test_phj_launches_match_the_model(card, schedule):
    from repro_torch.core import default_shj_bits
    from repro_torch.core.coprocess import CoProcessor
    from repro_torch.core.relation import Relation
    from repro_torch.kernels import launch_counts, reset_launch_counts
    n = 1 << 20
    spec = {"rows": n, "keys": {"dist": "uniform", "range": n}}
    (br, bk), (pr, pk) = (make_relation(spec, card, 3, s) for s in "RS")
    cp = CoProcessor(c_device="cpu", g_device=card)

    def query():
        return cp.phj(Relation(br, bk), Relation(pr, pk), schedule=schedule,
                      shj_bits=default_shj_bits(n, sum(schedule)),
                      max_out=4 * n, partition_ratio=0.0, join_ratio=0.0)

    query()
    torch.cuda.synchronize()
    reset_launch_counts()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        res, _ = query()
        torch.cuda.synchronize()
    counted = {k: launch_counts()[c] for k, c in rl.COUNTER_OF.items()}
    model = Counter(k for k, _ in rl.phj_query_launches(
        n, n, schedule, partition_ratio=0.0, join_ratio=0.0,
        build_layout_hit=False, probe_layout_hit=False))
    assert +Counter(counted) == model
    seen = {rl.kernel_letter(e.name) for e in prof.events()} - {None}
    assert seen == set(model)
    c = int(res.count)
    assert wrong_pairs(pair_codes(res.probe_rid[:c], res.build_rid[:c]),
                       join_pairs(br, bk, pr, pk)) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["phj_paper_16m.cold",
                                  "phj_paper_16m.repeat",
                                  "ssb_sf2.flights23"])
def test_a_small_run_on_the_card_is_correct(card, cell):
    res = _tiny.run(cell, trace=True, device=card)
    assert res["correct"] is True, res["compared"]
    assert res["device"]["busy_s"] > 0
    ssb = cell == _tiny.SSB
    ctl = _tiny.run(cell, control=True, device=card,
                    seconds=3.0 if ssb else 1.0,
                    override=_tiny.few_groups if ssb else None)
    assert ctl["correct"] is False
