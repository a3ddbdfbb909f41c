"""The readers of the join service's spans (``fingerprint``,
``fingerprint.pull``, ``lock_wait``, the device-timed ``join.build`` and
``join.probe``): a tiny traced run of each PHJ cell on the CPU reads the
three host metrics and not the two device metrics, and spans of a
program that records none of them read nothing."""
import types

import pytest

from bench import harness
from bench.records import Readings
from bench.tests import _tiny

HOST = ("table_cache.fingerprint_ms", "table_cache.fingerprint_pull_ms",
        "service.lock_wait_ms")
DEVICE = ("coprocessor.join_build_device_ms",
          "coprocessor.join_probe_device_ms")


@pytest.mark.parametrize("cell", ["phj_paper_16m.cold",
                                  "phj_paper_16m.repeat"])
def test_a_tiny_traced_run_reads_the_host_span_metrics(cell):
    res = _tiny.run(cell, trace=True)
    assert res["correct"] is True, res["compared"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert all(m[name] >= 0 for name in HOST), m
    assert not set(DEVICE) & set(m)
    pulled = m["table_cache.fingerprint_pull_ms"]
    assert (pulled == 0) if cell.endswith(".repeat") else (pulled > 0)
    assert m["table_cache.fingerprint_ms"] >= pulled


def _span(name, key, t0, t1, **extra):
    return types.SimpleNamespace(name=name, t0=t0, t1=t1, lane=None,
                                 thread="w", attrs={"q_key": key}, **extra)


def _read(metric, spans):
    return harness.reader(metric)(Readings([], spans, {}, {}, {}))


def test_without_the_spans_each_reader_reads_nothing():
    """The spans of a program that has none of these (no ``device_s``
    field either): every reader returns None."""
    spans = [_span("query", 1, 0.0, 1.0), _span("plan", 1, 0.1, 0.2),
             _span("join", 1, 0.3, 0.9)]
    for metric in HOST + DEVICE:
        assert _read(metric, spans) is None


def test_the_readers_sum_per_execution():
    spans = [_span("query", 1, 0.0, 1.0), _span("query", 2, 1.0, 2.0),
             _span("fingerprint", 1, 0.0, 0.25),
             _span("fingerprint.pull", 1, 0.0, 0.125),
             _span("fingerprint", 2, 1.0, 1.125),
             _span("fingerprint", 3, 2.0, 2.5),      # no query: not read
             _span("lock_wait", 2, 1.25, 1.75),
             _span("join.build", 1, 0.5, 0.6, device_s=0.004),
             _span("join.build", 2, 1.8, 1.9, device_s=0.002),
             _span("join.probe", 1, 0.6, 0.7, device_s=None)]
    assert _read("table_cache.fingerprint_ms", spans) == pytest.approx(
        1e3 * (0.25 + 0.125) / 2)
    assert _read("table_cache.fingerprint_pull_ms", spans) == \
        pytest.approx(1e3 * 0.125 / 2)
    assert _read("service.lock_wait_ms", spans) == pytest.approx(250.0)
    assert _read("coprocessor.join_build_device_ms", spans) == \
        pytest.approx(3.0)
    assert _read("coprocessor.join_probe_device_ms", spans) is None
