"""The reader of the CSR expand's split path,
``coprocessor.split_pair_share``, on the CPU: the share from spans that
carry the counts, nothing from spans without them, and its entry in the
benchmark."""
import types

import pytest

from bench import harness
from bench.records import Readings

METRIC = "coprocessor.split_pair_share"
CELLS = ["phj_zipf_16m.probe_skew", "phj_zipf_16m.build_skew"]


def _span(name, key, **attrs):
    return types.SimpleNamespace(name=name, t0=0.0, t1=1.0, lane=None,
                                 thread="w", device_s=attrs.pop("dev", None),
                                 attrs={"q_key": key, **attrs})


def _read(spans):
    return harness.reader(METRIC)(Readings([], spans, {}, {}, {}))


def test_split_share_sums_the_window_executions_expands():
    spans = [_span("query", 1), _span("query", 2),
             _span("join.expand", 1, pairs=100, split_pairs=40),
             _span("join.expand", 1, pairs=100, split_pairs=0),
             _span("join.expand", 2, pairs=200, split_pairs=60),
             _span("join.expand", 3, pairs=999, split_pairs=999)]  # no query
    assert _read(spans) == pytest.approx(25.0)


def test_split_share_is_zero_where_no_list_is_split():
    spans = [_span("query", 1),
             _span("join.expand", 1, pairs=100, heavy_pairs=0,
                   warp_max_pairs=1, split_pairs=0)]
    assert _read(spans) == 0.0


@pytest.mark.parametrize("spans", [
    [_span("query", 1), _span("join.probe", 1, dev=0.002)],   # no expand
    [_span("query", 1), _span("join.expand", 1)],             # no counts
    [_span("query", 1), _span("join.expand", 1, pairs=100, heavy_pairs=60,
                              warp_max_pairs=50)],            # three counts
    [_span("query", 1), _span("join.expand", 1, pairs=0, split_pairs=0)],
])
def test_split_share_reads_nothing_without_the_counts(spans):
    """A program whose ``join.expand`` carries no ``split_pairs`` (the
    parent's three counters), or no pairs at all: None, not 0."""
    assert _read(spans) is None


def test_split_share_is_a_co_processor_metric_of_the_zipf_cells():
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    (entry,) = [m for m in spec["per_layer"] if m["name"] == METRIC]
    assert entry == {"name": METRIC, "unit": "%", "better": "lower",
                     "source": "program_counter", "layer": "co-processor",
                     "moves": "input_Mrows_per_s", "workloads": CELLS}
    for cell in CELLS:
        _, layer = harness.cell_metrics(spec, cell)
        assert METRIC in {m["name"] for m in layer}
