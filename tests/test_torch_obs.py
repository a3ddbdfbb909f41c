"""Port parity for the observability package: ``repro_torch.obs`` against
``repro.obs``.  Each module gets the same scripted event sequence under a
fake clock, in both packages; snapshots, percentiles, drift alarms,
burn-rate verdicts, ledger totals per cause, q-errors and flight dumps
must be equal, exactly."""
import types

import numpy as np
import pytest

import repro.obs as jobs
import repro_torch.obs as tobs


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class Recorder:
    """Tracer stand-in that keeps the instants it is given."""

    enabled = True

    def __init__(self):
        self.instants = []

    def instant(self, name, **attrs):
        self.instants.append((name, sorted(attrs.items())))


def _metrics(m):
    clk = FakeClock()
    reg = m.MetricsRegistry(histogram_window=16, histogram_window_s=10.0,
                            max_events=8, clock=clk)
    rng = np.random.default_rng(3)
    for i in range(40):
        clk.t = 0.5 * i
        reg.inc("admitted", tenant=f"t{i % 3}")
        reg.inc("host_bytes_moved", int(rng.integers(1, 1 << 20)))
        reg.observe("query_latency_s", float(rng.exponential(0.02)),
                    tenant=f"t{i % 2}")
        reg.set_gauge("queue_depth_peak", float(i % 7))
        reg.event("tick", i=i)
    reg.register_collector("static", lambda: {"a": 1})
    return {"snapshot": reg.snapshot(),
            "hist": reg.histogram_summary("query_latency_s", tenant="t0"),
            "total": reg.counter_value("admitted"),
            "series": sorted(reg.counter_series("admitted").items()),
            "events": reg.events("tick"),
            "pct": [m.metrics._percentile(sorted(rng.random(17)), q)
                    for q in (0.0, 0.5, 0.9, 0.99, 1.0)]}


def _audit(m):
    audit = m.CostAudit(max_records=32)
    seen = []
    audit.add_listener(seen.append)
    rng = np.random.default_rng(4)
    for qid in range(50):
        pairs = [("build", "DD", float(rng.random()), float(rng.random())),
                 ("probe", "GPU_ONLY", float(rng.random() * (qid % 5)),
                  float(rng.random()))]
        audit.record(pairs, tenant=f"t{qid % 2}", query_id=qid)
    return {"summary": audit.summary(), "records": audit.records(),
            "seen": len(seen), "capacity": audit.capacity}


def _cardinality(m):
    card = m.CardinalityAudit(max_records=16)
    rng = np.random.default_rng(5)
    qs = [card.record(stage_type=("join", "semi", "groupby")[i % 3],
                      est_rows=float(rng.exponential(1000.0)),
                      observed_rows=int(rng.integers(0, 5000)),
                      depth=i % 4, tenant=f"t{i % 2}", stage_id=i)
          for i in range(30)]
    return {"q": qs, "summary": card.summary(), "records": card.records(),
            "q_error": [m.q_error(e, o) for e, o in
                        ((0.3, 0), (10, 1000), (1000, 10), (5, 5))]}


def _ledger(m):
    reg = m.MetricsRegistry()
    ledger = m.TransferLedger(reg, max_entries=8)
    rng = np.random.default_rng(6)
    for i in range(40):
        ledger.record(int(rng.integers(0, 1 << 16)),
                      cause=m.CAUSES[i % len(m.CAUSES)],
                      stage=f"s{i % 3}", column=("key", "rid")[i % 2],
                      direction=("d2h", "h2d")[i % 2], tenant="t")
    for bad in ({"cause": "nope"}, {"cause": "handoff", "direction": "up"}):
        with pytest.raises(ValueError):
            ledger.record(8, **bad)
    return {"summary": ledger.summary(), "by_cause": ledger.by_cause(),
            "by_stage": ledger.by_stage(), "entries": ledger.entries(),
            "total": ledger.total(),
            "all": ledger.total(intermediate_only=False),
            "moved": reg.counter_value("host_bytes_moved")}


def _drift(m):
    clk = FakeClock()
    reg = m.MetricsRegistry(clock=clk)
    tracer = Recorder()
    flagged, margins = [], {}
    det = m.DriftDetector(metrics=reg, tracer=tracer,
                          on_drift=lambda p, s, st: flagged.append(
                              (p, s, sorted(st.items()))),
                          on_margin=margins.__setitem__, threshold=0.5,
                          min_samples=4, margin_min_samples=4, clock=clk)
    rng = np.random.default_rng(7)
    for i in range(80):
        clk.t = float(i)
        ratio = float(np.exp(rng.normal(0.0 if i < 30 else 1.1, 0.05)))
        det.observe_record({"phase": ("probe", "join")[i % 2],
                            "scheme": "DD", "tenant": f"t{i % 3}",
                            "ratio": ratio})
    for bad in (None, 0.0, -1.0, float("nan"), float("inf")):
        det.observe_record({"phase": "probe", "scheme": "DD",
                            "ratio": bad})
    det.mark_repriced("probe", "DD")
    ph = m.PageHinkley(delta=0.05, threshold=0.5, min_samples=8)
    xs = np.concatenate([rng.normal(0.0, 0.02, 40),
                         rng.normal(0.9, 0.02, 40)])
    fires = [ph.update(float(x)) for x in xs]
    return {"summary": det.summary(), "flagged": flagged,
            "margins": margins, "margin_t0": det.margin_of("t0"),
            "snapshot": reg.snapshot(), "instants": tracer.instants,
            "ph": fires}


def _slo(m):
    clk = FakeClock()
    reg = m.MetricsRegistry(clock=clk)
    obj = m.SLObjective("deadline", good="deadline_hits",
                        bad="deadline_misses", target=0.75,
                        fast_window_s=60.0, slow_window_s=300.0,
                        burn_threshold=2.0, min_events=8)
    mon = m.SLOMonitor(reg, [obj, *m.default_objectives()], clock=clk,
                       tracer=Recorder())
    verdicts = [mon.evaluate(force=True)]
    rng = np.random.default_rng(8)
    for step in range(1, 30):
        for _ in range(int(rng.integers(0, 6))):
            reg.inc("deadline_hits", tenant=("gold", "bronze")[step % 2])
        for _ in range(int(rng.integers(0, 8 if 10 <= step < 16 else 2))):
            reg.inc("deadline_misses", tenant="gold")
        reg.inc("admitted", tenant="gold")
        if step % 5 == 0:
            reg.inc("shed", tenant="gold")
        clk.t = 25.0 * step
        verdicts.append(mon.evaluate(force=step % 3 != 0))
    return {"verdicts": verdicts, "alerts": mon.alerts(),
            "summary": mon.summary(), "events": reg.events("slo"),
            "budget": obj.error_budget}


def _outcome(qid, tenant, hit):
    plan = types.SimpleNamespace(algorithm="phj", scheme="DD",
                                 kind="inner", schedule=(7, 6),
                                 est_s=0.125 * qid)
    timing = types.SimpleNamespace(phase_s={"partition": 0.001 * qid,
                                            "join": 0.002})
    return types.SimpleNamespace(plan=plan, timing=timing, query_id=qid,
                                 tag="uniform", tenant=tenant,
                                 queued_s=0.0, wall_s=0.01 * qid,
                                 deadline_hit=hit, degraded=False,
                                 cache_hit=qid % 2 == 0)


def _flight(m):
    clk = FakeClock()
    fr = m.FlightRecorder(capacity=8, tenant_capacity=3, clock=clk,
                          storm_n=3, storm_window_s=5.0, burst_n=2,
                          burst_window_s=5.0, min_dump_gap_s=10.0)
    for i in range(12):
        clk.t = 1.5 * i
        fr.record_outcome(_outcome(i, f"t{i % 2}", i % 3 != 0))
        fr.record_admission(("shed", "degrade", "reject")[i % 3],
                            tenant=f"t{i % 2}", query_id=i)
        if i % 4 == 0:
            fr.record_resilience("retry", tenant="t0", query_id=i)
    fr.record_failure(tenant="t1", query_id=99, error="boom")
    clk.t = 40.0
    fr.record_failure(tenant="t1", query_id=100, error="boom")
    bundle = fr.dump("manual")
    return {"dump": bundle, "valid": m.validate_dump(bundle),
            "auto": list(fr.auto_dumps), "summary": fr.summary(),
            "len": len(fr)}


SCENARIOS = {"metrics": _metrics, "audit": _audit,
             "cardinality": _cardinality, "ledger": _ledger,
             "drift": _drift, "slo": _slo, "flight": _flight}


@pytest.mark.parametrize("module", list(SCENARIOS))
def test_module_matches_reference(module):
    want = SCENARIOS[module](jobs)
    got = SCENARIOS[module](tobs)
    assert got == want


def test_package_exports_match_reference():
    assert tobs.__all__ == jobs.__all__
    assert tobs.CAUSES == jobs.CAUSES
    assert tobs.INTERMEDIATE_CAUSES == jobs.INTERMEDIATE_CAUSES
