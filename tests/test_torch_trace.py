"""The port's ``Tracer`` (``repro_torch.obs.trace``) and the spans the
join service records with it: nesting and ambient attributes, device
timing, the ring of newest spans, and the service's ``fingerprint`` and
``lock_wait`` spans on the CPU."""
import dataclasses
import threading

import numpy as np
import pytest
import torch

import repro_torch.core as tc
import repro_torch.engine as te
from repro_torch.obs import trace as trace_mod
from repro_torch.obs.trace import NULL_TRACER, Tracer

CPU = torch.device("cpu")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


# ---------------------------------------------------------------------------
# The tracer alone.
# ---------------------------------------------------------------------------
def test_spans_nest_and_inherit_ambient_attributes():
    tr = Tracer(clock=FakeClock())
    with tr.span("query", q_key=7, tenant="a", kind="inner") as q:
        q.set(scheme="GPU_ONLY", ignored=None)
        with tr.span("fingerprint", side="build", memo=None):
            with tr.span("fingerprint.pull"):
                pass
        with tr.span("plan", tenant="b"):
            pass
    recs = {r.name: r for r in tr.spans()}
    assert [r.name for r in tr.spans()] == ["fingerprint.pull", "fingerprint",
                                            "plan", "query"]
    assert recs["fingerprint.pull"].attrs == {"q_key": 7, "tenant": "a",
                                              "scheme": "GPU_ONLY"}
    assert recs["fingerprint"].attrs == {"q_key": 7, "tenant": "a",
                                         "scheme": "GPU_ONLY",
                                         "side": "build"}
    assert recs["plan"].attrs["tenant"] == "b"
    assert "kind" not in recs["plan"].attrs         # not ambient
    for child, parent in (("fingerprint.pull", "fingerprint"),
                          ("fingerprint", "query"), ("plan", "query")):
        assert recs[parent].t0 < recs[child].t0 < recs[child].t1 \
            < recs[parent].t1
    assert {r["name"] for r in tr.spans_for(7)} == set(recs)
    assert all(r.device_s is None for r in tr.spans())


def test_spans_nest_per_thread():
    tr = Tracer()
    barrier = threading.Barrier(2, timeout=10)

    def work(key):
        with tr.span("query", q_key=key):
            barrier.wait()
            with tr.span("plan"):
                barrier.wait()

    threads = [threading.Thread(target=work, args=(k,), name=f"w{k}")
               for k in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    for k in (1, 2):
        recs = tr.spans_for(k)
        assert [r["name"] for r in recs] == ["plan", "query"]
        assert {r["thread"] for r in recs} == {f"w{k}"}


def test_device_timing_on_the_cpu_is_none():
    tr = Tracer()
    with tr.span("join", device=CPU):
        with tr.span("join.build", device=CPU) as sp:
            assert sp is not None
        tr.resolve_device()
    assert [r.device_s for r in tr.spans()] == [None, None]
    assert all(r.to_dict()["device_s"] is None for r in tr.spans())
    assert all("device_s" not in e.get("args", {})
               for e in tr.chrome_trace())


class FakeEvent:
    """Stands in for ``torch.cuda.Event``: ``record`` stamps a time,
    ``query`` says whether the device has passed it."""
    made = 0

    def __init__(self, device_time):
        FakeEvent.made += 1
        self.device_time, self.t, self.done = device_time, None, False

    def record(self, stream=None):
        self.t, self.done = self.device_time[0], False

    def query(self):
        return self.done

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)          # ms, as CUDA's


@pytest.fixture
def fake_cuda(monkeypatch):
    """CUDA events faked on a device clock the test advances."""
    device_time = [0.0]
    monkeypatch.setattr(trace_mod.torch.cuda, "current_stream",
                        lambda device=None: None)
    monkeypatch.setattr(trace_mod.torch.cuda, "Event",
                        lambda enable_timing: FakeEvent(device_time))
    FakeEvent.made = 0
    return device_time


CARD = torch.device("cuda", 0)


def _timed_query(tr, device_time, build_s, probe_s):
    with tr.span("join.build", device=CARD):
        device_time[0] += build_s
    with tr.span("join.probe", device=CARD):
        device_time[0] += probe_s


def _device_passes(tr):
    for _, _, start, end in tr._pending:
        start.done = end.done = True


def test_device_timed_spans_resolve_when_read_and_reuse_events(fake_cuda):
    """``device_s`` is None until the device has passed the closing
    event; reading the spans then resolves it, and the resolved events go
    back to the pool, so a second query makes no new ones."""
    tr = Tracer()
    _timed_query(tr, fake_cuda, 0.25, 0.5)
    assert FakeEvent.made == 4
    assert [r.device_s for r in tr.spans()] == [None, None]
    assert len(tr._pending) == 2                # nothing complete yet
    _device_passes(tr)
    assert [r.device_s for r in tr.spans()] == [0.25, 0.5]
    assert tr._pending == []
    assert tr.spans()[0].to_dict()["device_s"] == 0.25
    args = [e["args"] for e in tr.chrome_trace() if e["ph"] == "X"]
    assert sorted(a["device_s"] for a in args) == [0.25, 0.5]
    _timed_query(tr, fake_cuda, 0.125, 0.125)
    assert FakeEvent.made == 4                  # from the pool
    _device_passes(tr)
    assert [r.device_s for r in tr.spans()][2:] == [0.125, 0.125]


def test_device_time_resolves_on_any_thread_and_waits_for_the_device(
        fake_cuda):
    """A span timed on a worker thread is resolved by a reader on
    another; one whose closing event the device has not passed stays
    pending while the others resolve."""
    tr = Tracer()
    worker = threading.Thread(
        target=_timed_query, args=(tr, fake_cuda, 0.5, 0.25))
    worker.start()
    worker.join(timeout=10)
    assert not worker.is_alive()
    _device_passes(tr)
    _timed_query(tr, fake_cuda, 0.125, 0.125)   # not passed yet
    tr.resolve_device()
    assert [r.device_s for r in tr.spans()] == [0.5, 0.25, None, None]
    assert [p[0].name for p in tr._pending] == ["join.build", "join.probe"]
    assert sum(len(v) for v in tr._events.values()) == 4
    _device_passes(tr)
    tr.resolve_device()
    assert [r.device_s for r in tr.spans()][2:] == [0.125, 0.125]
    assert tr._pending == [] and FakeEvent.made == 8


def test_unread_device_timed_spans_stay_bounded(fake_cuda):
    """Where nothing reads the spans, opening more resolves the pending
    ones the device has passed, so events and pending spans stay
    bounded."""
    tr = Tracer()
    for _ in range(200):
        _timed_query(tr, fake_cuda, 0.25, 0.25)
        _device_passes(tr)
    assert len(tr._pending) <= trace_mod.MAX_PENDING + 2
    assert FakeEvent.made <= 2 * (trace_mod.MAX_PENDING + 2)
    assert all(r.device_s == 0.25 for r in list(tr._spans)[:300])


def test_per_query_trace_carries_device_time(fake_cuda):
    tr = Tracer()
    with tr.span("query", q_key=3):
        _timed_query(tr, fake_cuda, 0.25, 0.75)
    assert [r["device_s"] for r in tr.spans_for(3)] == [None, None, None]
    _device_passes(tr)
    assert [(r["name"], r["device_s"]) for r in tr.spans_for(3)] == [
        ("join.build", 0.25), ("join.probe", 0.75), ("query", None)]


def test_null_tracer_records_nothing():
    with NULL_TRACER.span("join.build", device=CPU, q_key=1) as sp:
        assert sp is None
    NULL_TRACER.instant("shed")
    NULL_TRACER.lane("queue", 0.0, 1.0)
    NULL_TRACER.resolve_device()
    assert NULL_TRACER.spans() == [] and NULL_TRACER.dropped == 0
    assert NULL_TRACER._pending == [] and NULL_TRACER.spans_for(1) == []


def test_the_ring_keeps_the_newest_spans():
    tr = Tracer(clock=FakeClock(), max_spans=5)
    for key in (1, 1, 1, 2, 2, 2, 3, 3):
        with tr.span("step", q_key=key):
            pass
    tr.instant("mark")
    assert tr.dropped == 4
    assert [r.attrs.get("q_key") for r in tr.spans()] == [2, 2, 3, 3, None]
    assert tr.spans_for(1) == []
    assert len(tr.spans_for(2)) == 2 and len(tr.spans_for(3)) == 2
    assert set(tr._by_key) == {2, 3}
    with tr.span("step", q_key=4):
        pass
    assert tr.spans()[-1].attrs["q_key"] == 4 and tr.dropped == 5
    tr.clear()
    assert tr.spans() == [] and tr.dropped == 0


# ---------------------------------------------------------------------------
# The service's spans.
# ---------------------------------------------------------------------------
NEW = ("fingerprint", "fingerprint.pull", "fingerprint.hash", "lock_wait")


def _covered(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _self_s(spans, ignore=()) -> float:
    """Total over executions of ``admit`` and ``query`` spans less the
    union of the spans nested in them on their thread (the service's self
    time), ignoring spans named in ``ignore``."""
    by_key: dict = {}
    for s in spans:
        if s.attrs.get("q_key") is not None and s.lane is None \
                and s.name not in ignore:
            by_key.setdefault(s.attrs["q_key"], []).append(s)
    total = 0.0
    for recs in by_key.values():
        for top in recs:
            if top.name in ("admit", "query"):
                total += (top.t1 - top.t0) - _covered(
                    (s.t0, s.t1) for s in recs if s is not top
                    and s.thread == top.thread and s.t0 >= top.t0
                    and s.t1 <= top.t1)
    return total


def _phj_planner():
    class ForcePhj(te.QueryPlanner):
        def choose(self, build_n, probe_n, *, max_out, **kw):
            plan = self._phj_candidate(build_n, probe_n)
            return dataclasses.replace(
                plan, schedule=(4, 4), max_out=int(max_out),
                shj_bits=tc.default_shj_bits(build_n, 8))

    return ForcePhj(delta=0.25, min_feedback_items=1 << 40)


def _relation(seed, n=4096):
    rng = np.random.default_rng(seed)
    return tc.Relation(torch.arange(n, dtype=torch.int32),
                       torch.from_numpy(rng.integers(0, n, n)
                                        .astype(np.int32)))


def test_service_spans_fingerprints_and_lock_waits():
    """Two clients, fresh and repeated relations, through a two-worker
    service on the CPU: every fingerprint is spanned with its side and memo
    outcome (each column's pull and hash inside on a miss),
    every lock wait with its group, and the self time of the spans
    before them equals the new self time plus fingerprints plus lock
    waits."""
    svc = te.JoinQueryService(
        cp=tc.CoProcessor(c_device="cpu", g_device="cpu"),
        planner=_phj_planner(), num_workers=2)
    shared = _relation(0), _relation(1)
    errors = []

    def client(c):
        try:
            for i in range(4):
                r, s = shared if i % 2 else (_relation(10 * c + i),
                                            _relation(100 + 10 * c + i))
                out = svc.submit(te.JoinQuery(r, s, query_id=10 * c + i,
                                              max_out=4 * 4096 + 1024))(60)
                assert out.plan.algorithm == "phj"
                assert np.array_equal(out.result.valid_pairs(),
                                      tc.join_oracle(r, s))
        except Exception as e:          # reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    svc.close()
    assert not any(t.is_alive() for t in threads) and not errors, errors
    spans = svc.tracer.spans()
    fps = [s for s in spans if s.name == "fingerprint"]
    # Per query: the build side at admission and in the query, and the
    # probe side in the query.
    assert len(fps) == 3 * 8
    assert {s.attrs["side"] for s in fps} == {"build", "probe"}
    assert {s.attrs["memo"] for s in fps} == {"hit", "miss"}
    assert all(s.attrs["q_key"] is not None for s in fps)
    for fp in fps:
        kids = [s for s in spans if s.name.startswith("fingerprint.")
                and s.thread == fp.thread and fp.t0 <= s.t0 <= s.t1 <= fp.t1]
        if fp.attrs["memo"] == "miss":
            # Key, then rid: each pulled, then hashed.
            assert [s.name for s in sorted(kids, key=lambda s: s.t0)] == \
                ["fingerprint.pull", "fingerprint.hash"] * 2
            assert all(s.attrs["q_key"] == fp.attrs["q_key"] for s in kids)
        else:
            assert kids == []
    parents = {s.attrs["q_key"]: {} for s in fps}
    for s in spans:
        if s.name in ("admit", "query") and s.attrs.get("q_key") in parents:
            parents[s.attrs["q_key"]][s.name] = s
    for fp in fps:
        top = parents[fp.attrs["q_key"]]
        assert any(p.thread == fp.thread and p.t0 <= fp.t0 <= fp.t1 <= p.t1
                   for p in top.values())
    waits = [s for s in spans if s.name == "lock_wait"]
    assert len(waits) >= 8
    assert {s.attrs["group"] for s in waits} <= {"C", "G"}
    assert all(any(p.thread == s.thread and p.t0 <= s.t0 <= s.t1 <= p.t1
                   for p in [parents[s.attrs["q_key"]]["query"]])
               for s in waits)
    new_total = sum(s.t1 - s.t0 for s in spans
                    if s.name in ("fingerprint", "lock_wait"))
    old = _self_s(spans, ignore=NEW)
    assert old == pytest.approx(_self_s(spans) + new_total, rel=0.02)


def test_fingerprint_digest_is_unchanged_by_its_spans():
    rel = _relation(5)
    tr = Tracer()
    assert te.relation_fingerprint(rel, 1024, tracer=tr) == \
        te.relation_fingerprint(rel, 1024)
    assert [r.name for r in tr.spans()] == ["fingerprint.pull",
                                            "fingerprint.hash"] * 2
