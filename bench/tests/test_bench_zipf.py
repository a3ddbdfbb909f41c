"""The ``phj_zipf_16m`` deployment: its configuration and traffic files,
the ``phj_roles`` driver's orientation, the unique-key control, and the
readers of the CSR expand's span and counts, on the CPU at test size (and
a small run of each cell on the card, marked ``cuda``)."""
import time
import types

import pytest
import torch

from bench import harness
from bench.data.zipf_keys import zipf_keys
from bench.drivers.phj_roles import Driver
from bench.reference.join import join_pairs, wrong_pairs
from bench.reference.unique_join import unique_key_pairs
from bench.records import Readings
from bench.tests import _tiny

CELLS = ["phj_zipf_16m.probe_skew", "phj_zipf_16m.build_skew"]
BUILT = {"phj_zipf_16m.probe_skew": "primary",
         "phj_zipf_16m.build_skew": "foreign"}
NEW = ("coprocessor.join_expand_device_ms", "coprocessor.heavy_pair_share",
       "coprocessor.expand_warp_max_pairs")
SEED = 2**33 + 5


def shrink(config: dict, traffic: dict, rows: int = 1 << 12) -> None:
    """Both relations to ``rows`` tuples (F's key range alike), a check
    of 3 of the first 4 queries, calibration at 2^10."""
    for role in ("primary", "foreign"):
        config["data"][role]["rows"] = rows
    config["data"]["foreign"]["keys"]["range"] = rows
    traffic["check"] = {"sample": 3, "of_first": 4}
    config["deployment"]["calibration"] = {"n": 1 << 10, "reps": 1,
                                           "delta": 0.1}


def run(cell, *, trace=False, control=False, device="cpu"):
    return harness.run(cell, SEED, 1.0, trace, t_start=time.perf_counter(),
                       device=device, control=control,
                       config_override=shrink, log=lambda *a: None)


def test_configuration_is_the_paper_size_with_a_zipf_foreign_key():
    spec, _, config, _ = harness.cell_spec(CELLS[0])
    data = config["data"]
    assert data["primary"] == {"rows": 1 << 24, "keys": {"dist": "unique"}}
    assert data["foreign"] == {"rows": 1 << 24, "keys": {
        "dist": "zipf", "range": 1 << 24, "s": 1.0}}
    assert config["reduced"] == [] and "s" in config["assumed"]
    entry = {c["name"]: c for c in spec["configs"]}["phj_zipf_16m"]
    assert entry["reduced"] == [] and entry["source"] == config["source"]
    assert entry["file"] == "bench/configs/phj_zipf_16m.json"
    paper = harness.load_json(harness.BENCH / "configs" /
                              "phj_paper_16m.json")
    assert config["deployment"] == paper["deployment"]


@pytest.mark.parametrize("cell", CELLS)
def test_traffic_is_the_repeat_cells_with_a_side_built(cell):
    spec, entry, _, traffic = harness.cell_spec(cell)
    repeat = harness.cell_spec("phj_paper_16m.repeat")[3]
    assert entry["chips"] == 1 and traffic["driver"] == "phj_roles"
    assert traffic["build"] == BUILT[cell]
    for key in ("clients", "inputs", "pool", "warm_passes", "check"):
        assert traffic[key] == repeat[key], key
    e2e, layer = harness.cell_metrics(spec, cell)
    assert {m["name"] for m in e2e} == {"input_Mrows_per_s", "setup_s"}
    assert set(NEW) <= {m["name"] for m in layer}


def test_driver_builds_the_relation_the_traffic_names():
    """For one seed both cells draw the same P and F; ``build_skew``
    builds F (keys repeat), ``probe_skew`` builds P (keys unique)."""
    made = {}
    for cell in CELLS:
        _, _, config, traffic = harness.cell_spec(cell)
        shrink(config, traffic)
        d = Driver(config, traffic, SEED, "cpu")
        made[cell] = d._tensors(("pool", 1))
        (_, bk), (_, pk) = made[cell]
        unique = {torch.unique(k).numel() == k.numel() for k in (bk, pk)}
        assert unique == {True, False}
        assert (torch.unique(bk).numel() == bk.numel()) == (
            BUILT[cell] == "primary")
    (pb, pp), (fb, fp) = made[CELLS[0]], made[CELLS[1]]
    for x, y in ((pb, fp), (pp, fb)):
        assert all(torch.equal(a, b) for a, b in zip(x, y))
    with pytest.raises(ValueError):
        Driver(config, {**traffic, "build": "probe"}, SEED, "cpu")


@pytest.mark.parametrize("s", [1.0, 0.5, 1.5])
def test_zipf_keys_follow_the_law_and_repeat(s):
    """Rank k's share of 2^16 draws over 2^16 keys is k^-s / H within
    five standard deviations for the three hottest ranks; the same seed
    and stream give the same keys, another stream others."""
    n = 1 << 16
    spec = {"dist": "zipf", "range": n, "s": s}
    keys = zipf_keys(spec, n, "cpu", SEED, "x")
    assert keys.dtype == torch.int32 and 0 <= int(keys.min()) \
        and int(keys.max()) < n
    assert torch.equal(keys, zipf_keys(spec, n, "cpu", SEED, "x"))
    assert not torch.equal(keys, zipf_keys(spec, n, "cpu", SEED, "y"))
    top = torch.bincount(keys.long()).sort(descending=True).values[:3]
    h = sum(k ** -s for k in range(1, n + 1))
    for k, got in enumerate(top.tolist(), start=1):
        want = n * k ** -s / h
        assert abs(got - want) < 5 * want ** 0.5 + 1, (k, got, want)
    with pytest.raises(ValueError):
        zipf_keys({"dist": "unique"}, n, "cpu", SEED)


def test_unique_key_control_by_hand():
    t = lambda *v: torch.tensor(v, dtype=torch.int32)   # noqa: E731
    # build keys 1, 2, 2, 3 (rids 0-3); probe keys 2, 3, 4, 2 (rids 0-3)
    got = unique_key_pairs(t(0, 1, 2, 3), t(1, 2, 2, 3),
                           t(0, 1, 2, 3), t(2, 3, 4, 2))
    assert got.tolist() == [(0 << 32) | 1, (1 << 32) | 3]
    assert unique_key_pairs(t(), t(), t(0), t(5)).numel() == 0


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_and_the_control_is_not(cell):
    res = run(cell)
    assert res["correct"] is True, res["compared"]
    assert res["failed"] == 0 and res["attempted"] > 0
    ctrl = run(cell, control=True)
    assert ctrl["correct"] is False
    assert ctrl["compared"]["wrong_pairs"]["value"] > 0


@pytest.mark.parametrize("built", ["primary", "foreign"])
def test_the_control_is_wrong_in_both_orientations(built):
    """At 2^12, with either relation built, the unique-key join misses
    pairs the reference has."""
    _, _, config, traffic = harness.cell_spec(CELLS[0])
    shrink(config, traffic)
    d = Driver(config, {**traffic, "build": built}, SEED, "cpu")
    (br, bk), (pr, pk) = d._tensors(("pool", 0))
    want = join_pairs(br, bk, pr, pk)
    assert want.numel() == 1 << 12
    assert wrong_pairs(unique_key_pairs(br, bk, pr, pk), want) > 1 << 10


@pytest.mark.parametrize("cell", CELLS)
def test_the_generic_tiny_run_cuts_both_relations(cell):
    """``bench/tests/_tiny.run``, which the import test runs on every
    cell, cuts this configuration too (to SSB's 20,000 fact rows): its
    queries answer, and none is wrong (its check samples 12 of the first
    1000, which half a second need not reach)."""
    res = _tiny.run(cell, seconds=0.5)
    assert res["failed"] == 0 and res["attempted"] > 0
    assert all(v["value"] == 0 for k, v in res["compared"].items()
               if k != "answers_checked"), res["compared"]


def _span(name, key, **attrs):
    return types.SimpleNamespace(name=name, t0=0.0, t1=1.0, lane=None,
                                 thread="w", device_s=attrs.pop("dev", None),
                                 attrs={"q_key": key, **attrs})


def _read(metric, spans):
    return harness.reader(metric)(Readings([], spans, {}, {}, {}))


def test_expand_readers_by_execution():
    spans = [_span("query", 1), _span("query", 2),
             _span("join.expand", 1, pairs=100, heavy_pairs=60,
                   warp_max_pairs=50, dev=0.004),
             _span("join.expand", 1, pairs=100, heavy_pairs=10,
                   warp_max_pairs=20, dev=0.002),
             _span("join.expand", 2, pairs=200, heavy_pairs=30,
                   warp_max_pairs=10, dev=0.003),
             _span("join.expand", 3, pairs=999, heavy_pairs=999,
                   warp_max_pairs=999, dev=9.0)]       # no query: not read
    assert _read("coprocessor.join_expand_device_ms", spans) == \
        pytest.approx(4.5)
    assert _read("coprocessor.heavy_pair_share", spans) == pytest.approx(25.0)
    assert _read("coprocessor.expand_warp_max_pairs", spans) == 30


def test_expand_readers_read_nothing_without_the_span_or_counts():
    """A program without ``join.expand`` (the parent's), or whose spans
    carry no counts: every new reader returns None."""
    bare = [_span("query", 1), _span("join.probe", 1, dev=0.002)]
    uncounted = bare + [_span("join.expand", 1)]
    for metric in NEW:
        assert _read(metric, bare) is None
        assert _read(metric, uncounted) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_zipf_keys_repeat_bit_for_bit_on_the_card(card):
    """At the cells' size on the card, ten calls with one seed and stream
    give one tensor (the check remakes the run's relations)."""
    spec = {"dist": "zipf", "range": 1 << 24, "s": 1.0}
    first = zipf_keys(spec, 1 << 24, card, SEED, "pool", 3, "foreign")
    for _ in range(9):
        assert torch.equal(
            first, zipf_keys(spec, 1 << 24, card, SEED, "pool", 3, "foreign"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_small_traced_run_on_the_card_reads_the_expand(card, cell):
    """At 2^20 rows on the card: correct, the control not, and a traced
    run reads the expand's time and counts (warp-written lists only where
    F is built)."""
    def edit(config, traffic):
        shrink(config, traffic, rows=1 << 20)

    def go(trace, control=False):
        return harness.run(cell, SEED, 2.0, trace,
                           t_start=time.perf_counter(), device=card,
                           control=control, config_override=edit,
                           log=lambda *a: None)
    res = go(True)
    assert res["correct"] is True, res["compared"]
    assert go(False, control=True)["correct"] is False
    m = {k: v["value"] for k, v in res["metrics"].items()}
    if "coprocessor.join_expand_device_ms" in m:      # a PHJ plan ran
        assert m["coprocessor.join_expand_device_ms"] > 0
        share = m["coprocessor.heavy_pair_share"]
        longest = m["coprocessor.expand_warp_max_pairs"]
        if BUILT[cell] == "primary":
            assert share == 0 and longest == 1
        else:
            assert share > 50 and longest > 1 << 14
