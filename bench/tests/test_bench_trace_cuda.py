"""On the card: the join phase's device-timed spans, and the program's
span names kept out of the device operations the benchmark reads.  Run on a CUDA machine with ``python -m pytest -q
-m cuda bench/tests``; they skip without a card."""
import time

import pytest
import torch

from bench.data.relations import make_relation
from bench.devtrace import WINDOW, DeviceTrace
from bench.tests import _tiny

STEPS = ("join.build", "join.probe")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _traced_phj(card, n=1 << 20):
    """A traced ``CoProcessor`` on the card and a query of two uniform
    relations of ``n`` tuples through it, all on the G group."""
    from repro_torch.core import default_shj_bits
    from repro_torch.core.coprocess import CoProcessor
    from repro_torch.core.relation import Relation
    from repro_torch.obs import Tracer
    spec = {"rows": n, "keys": {"dist": "uniform", "range": n}}
    (br, bk), (pr, pk) = (make_relation(spec, card, 5, s) for s in "RS")
    cp = CoProcessor(c_device="cpu", g_device=card, tracer=Tracer())

    def query():
        return cp.phj(Relation(br, bk), Relation(pr, pk), schedule=(13,),
                      shj_bits=default_shj_bits(n, 13), max_out=4 * n,
                      partition_ratio=0.0, join_ratio=0.0)
    return cp, query


@pytest.mark.cuda
def test_join_steps_are_device_timed(card):
    cp, query = _traced_phj(card)
    query()
    cp.tracer.spans()                   # resolves, and fills the pool
    pool = sum(len(v) for v in cp.tracer._events.values())
    cp.tracer.clear()
    _, timing = query()
    spans = {s.name: s for s in cp.tracer.spans()}
    wall = timing.phase_s["join"]
    for name in STEPS:
        assert 0 < spans[name].device_s < wall, (name, spans[name])
    assert spans["join.build"].device_s + spans["join.probe"].device_s \
        < wall
    # A warm query takes its events from the pool.
    assert pool == 2 * len(STEPS)
    assert sum(len(v) for v in cp.tracer._events.values()) == pool


@pytest.mark.cuda
def test_span_names_stay_out_of_the_device_ops(card):
    """A traced query under the profiler: none of the program's span
    names among ``DeviceTrace.ops``."""
    cp, query = _traced_phj(card)
    query()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            t0 = time.perf_counter()
            query()
            torch.cuda.synchronize()
    names = {s.name for s in cp.tracer.spans()}
    assert set(STEPS) | {"partition", "join"} <= names
    ops = {n for n, _, _ in DeviceTrace.from_profile(prof, t0).ops}
    assert ops and not names & ops


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["phj_paper_16m.cold",
                                  "phj_paper_16m.repeat"])
def test_a_small_traced_run_reads_the_span_metrics(card, cell):
    res = _tiny.run(cell, trace=True, device=card)
    assert res["correct"] is True, res["compared"]
    m = res["metrics"]
    for name in ("table_cache.fingerprint_ms",
                 "table_cache.fingerprint_pull_ms", "service.lock_wait_ms"):
        assert name in m, m
    if "coprocessor.partition_ms" in m:          # a PHJ plan ran
        assert m["coprocessor.join_build_device_ms"]["value"] > 0
        assert m["coprocessor.join_probe_device_ms"]["value"] > 0
    program = {"fingerprint", "fingerprint.pull", "fingerprint.hash",
               "lock_wait", "admit", "query", "plan", "partition", "join",
               *STEPS}
    assert not program & {n for n, _ in res["breakdown"]["device_ops"]}
