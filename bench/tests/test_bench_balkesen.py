"""The ``phj_balkesen_a`` deployment (Balkesen et al., ICDE 2013, workload
A): its configuration and traffic files, a run and its control on the CPU
at 2^10 x 2^14, the reader of ``partition.probe``'s device time, and a
small traced run on the card (marked ``cuda``)."""
import time
import types

import pytest
import torch

from bench import harness
from bench.records import Readings

CELL = "phj_balkesen_a.cold"
METRIC = "coprocessor.partition_probe_device_ms"
SEED = 2**34 + 35


def shrink(config: dict, traffic: dict, rows: int = 1 << 10) -> None:
    """P to ``rows`` tuples and F to 16 ``rows`` over P's keys (workload
    A's 1:16), a check of 3 of the first 4 queries, calibration at
    2^10."""
    data = config["data"]
    data["primary"]["rows"] = rows
    data["foreign"]["rows"] = 16 * rows
    data["foreign"]["keys"]["range"] = rows
    traffic["check"] = {"sample": 3, "of_first": 4}
    config["deployment"]["calibration"] = {"n": 1 << 10, "reps": 1,
                                           "delta": 0.1}


def run(*, trace=False, control=False, device="cpu", rows=1 << 10,
        seconds=1.0):
    return harness.run(CELL, SEED, seconds, trace,
                       t_start=time.perf_counter(), device=device,
                       control=control,
                       config_override=lambda c, t: shrink(c, t, rows),
                       log=lambda *a: None)


def test_configuration_is_workload_a_at_its_published_size():
    spec, entry, config, traffic = harness.cell_spec(CELL)
    data = config["data"]
    assert data["primary"] == {"rows": 1 << 24, "keys": {"dist": "unique"}}
    assert data["foreign"] == {"rows": 1 << 28, "keys": {
        "dist": "uniform", "range": 1 << 24}}
    assert config["reduced"] == []
    assert config["reference"] == "bench/reference/join.py"
    conf = {c["name"]: c for c in spec["configs"]}["phj_balkesen_a"]
    assert conf["reduced"] == [] and conf["source"] == config["source"]
    assert "Balkesen" in conf["source"] and "ICDE 2013" in conf["source"]
    assert "workload A" in conf["source"]
    assert conf["file"] == "bench/configs/phj_balkesen_a.json"
    paper = harness.load_json(harness.BENCH / "configs" /
                              "phj_paper_16m.json")
    assert config["deployment"] == paper["deployment"]
    assert config["assumed"] == paper["assumed"]


def test_traffic_is_the_cold_cells_with_p_built_and_four_answers_kept():
    spec, entry, _, traffic = harness.cell_spec(CELL)
    cold = harness.cell_spec("phj_paper_16m.cold")[3]
    assert entry["chips"] == 1 and entry["config"] == "phj_balkesen_a"
    assert traffic["driver"] == "phj_roles" and traffic["build"] == "primary"
    for key in ("clients", "inputs", "warm_passes"):
        assert traffic[key] == cold[key], key
    assert (traffic["clients"], traffic["inputs"]) == (2, "fresh")
    assert traffic["check"] == {"sample": 4, "of_first": 40}
    e2e, layer = harness.cell_metrics(spec, CELL)
    assert {m["name"] for m in e2e} == {"input_Mrows_per_s", "setup_s"}
    names = {m["name"] for m in layer}
    assert METRIC in names and "kernels.phj_roofline" not in names
    entry = {m["name"]: m for m in spec["per_layer"]}[METRIC]
    assert entry["workloads"] == ["phj_paper_16m.cold", CELL]
    assert (entry["layer"], entry["moves"], entry["better"]) == (
        "co-processor", "input_Mrows_per_s", "lower")


def test_a_sound_run_is_correct_and_the_control_is_not():
    res = run()
    assert res["correct"] is True, res["compared"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["compared"]["answers_checked"]["value"] == 3
    ctrl = run(control=True)
    assert ctrl["correct"] is False
    assert ctrl["compared"]["wrong_pairs"]["value"] > 0


def _span(name, key, dev=None):
    return types.SimpleNamespace(name=name, t0=0.0, t1=1.0, lane=None,
                                 thread="w", device_s=dev,
                                 attrs={"q_key": key})


def _read(spans):
    return harness.reader(METRIC)(Readings([], spans, {}, {}, {}))


def test_reader_one_value_per_execution_and_zero_for_a_reused_layout():
    """Executions 1 and 2 partition S (one in two cooperative spans),
    execution 3 reuses S's layout and reads 0; R's spans and spans of
    no execution are not read."""
    spans = [_span("query", k) for k in (1, 2, 3)] + [
        _span("partition.probe", 1, dev=0.100),
        _span("partition.probe", 2, dev=0.050),
        _span("partition.probe", 2, dev=0.030),
        _span("partition.build", 1, dev=0.007),
        _span("partition.build", 3, dev=0.007),
        _span("partition.probe", 4, dev=9.0)]        # no query: not read
    assert _read(spans) == pytest.approx(1e3 * (0.100 + 0.080 + 0.0) / 3)


def test_reader_reads_nothing_without_the_span_or_its_device_time():
    """A program without ``partition.probe`` (the parent's), or a CPU G
    group whose spans carry no device time: the reader returns None."""
    bare = [_span("query", 1), _span("join.build", 1, dev=0.009)]
    assert _read(bare) is None
    assert _read(bare + [_span("partition.probe", 1)]) is None
    assert _read([_span("partition.probe", 1, dev=0.1)]) is None


def test_a_traced_cpu_run_leaves_the_metric_out():
    """On a CPU G group the spans exist but carry no device time: the
    line has the other metrics and not this one."""
    res = run(trace=True)
    assert res["correct"] is True
    assert "coprocessor.join_ms" in res["metrics"]
    assert METRIC not in res["metrics"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_small_traced_run_on_the_card_reads_the_probe_partition(card):
    """At 2^16 x 2^20 on the card: correct, and where a PHJ plan ran, the
    probe side's partition reads above 0."""
    res = run(trace=True, device=card, rows=1 << 16, seconds=2.0)
    assert res["correct"] is True, res["compared"]
    assert res["failed"] == 0
    m = {k: v["value"] for k, v in res["metrics"].items()}
    if "coprocessor.partition_ms" in m:             # a PHJ plan ran
        assert m[METRIC] > 0
