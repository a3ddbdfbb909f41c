"""Runs of the harness on the CPU at sizes a test can hold."""
from __future__ import annotations

import time

from bench import harness

SSB = "ssb_sf2.flights23"


def ssb_spec() -> dict:
    """BENCHMARK.json with the SSB cell and its two layers' metrics
    entered, as the change that makes it a cell would enter them (the cell
    is left out of the benchmark for now: PERF.md, section 7)."""
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    spec["workloads"].append({"name": SSB, "config": "ssb_sf2",
                              "traffic": "flights23", "chips": 1})
    for name, layer in (("optimizer.optimize_ms", "optimizer"),
                        ("executor.self_ms", "executor")):
        spec["per_layer"].append({"name": name, "unit": "ms",
                                  "better": "lower", "layer": layer,
                                  "source": "program_span",
                                  "moves": "input_Mrows_per_s",
                                  "workloads": [SSB]})
    for m in spec["per_layer"]:
        if m["moves"] == "input_Mrows_per_s" and "workloads" in m:
            m["workloads"].append(SSB)
    return spec


def cell(name: str):
    """(spec, cell, configuration, traffic) of any cell, the SSB one
    included."""
    return harness.cell_spec(name, ssb_spec() if name == SSB else None)


def shrink(config: dict, traffic: dict, *, rows: int = 1 << 12,
           lineorder: int = 20000) -> None:
    """Cut a configuration to CPU size, in place: the relations to
    ``rows`` tuples, SSB to ``lineorder`` fact rows, calibration to 2^10."""
    data = config["data"]
    if "build" in data:
        for side in ("build", "probe"):
            data[side]["rows"] = rows
            if "range" in data[side]["keys"]:
                data[side]["keys"]["range"] = rows
        traffic["check"] = {"sample": 3, "of_first": 4}
    else:
        data["rows"] = {"lineorder": lineorder, "customer": 300,
                        "supplier": 40, "part": 2000, "date": 2556}
    config["deployment"]["calibration"] = {"n": 1 << 10, "reps": 1,
                                           "delta": 0.1}


def few_groups(config: dict, traffic: dict) -> None:
    """SSB with one nation per region, one city per nation, one category
    per mfgr and one brand per category, at 2e5 fact rows: few enough
    groups that a group's sum passes 2^31, as at SF 2."""
    config["data"]["rows"]["lineorder"] = 200_000
    config["data"]["codes"].update(nations_per_region=1, cities_per_nation=1,
                                   categories_per_mfgr=1,
                                   brands_per_category=1)


def run(cell: str, *, seconds: float = 1.0, trace: bool = False,
        control: bool = False, seed: int = 2**31 + 11, override=None,
        device="cpu"):
    """One harness run of ``cell``, shrunk (then ``override`` edits the
    configuration and traffic further), on the CPU unless told."""
    def edit(config, traffic):
        shrink(config, traffic)
        if override is not None:
            override(config, traffic)
    return harness.run(cell, seed, seconds, trace, t_start=time.perf_counter(),
                       device=device, control=control, config_override=edit,
                       spec=ssb_spec() if cell == SSB else None,
                       log=lambda *a: None)
