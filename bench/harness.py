"""One run of one cell: set-up, the measured window, the check, the line.

Everything a cell needs is found by name: its entry in
``BENCHMARK.json``, ``configs/<config>.json``, ``traffic/<cell>.json``,
the driver module the traffic file names in ``drivers/``, and one reader
per per-layer metric in ``metrics/<metric>.py`` (a function ``read``
from ``bench.records.Readings`` to a number, or None when it finds
nothing to read).
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import torch

from .devtrace import WINDOW, DeviceTrace
from .records import Readings

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
SLOWEST = 5        # slowest queries named in the run's log


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(name: str, spec: dict | None = None
              ) -> tuple[dict, dict, dict, dict]:
    """(BENCHMARK.json or ``spec``, the cell, its configuration, its
    traffic)."""
    spec = spec or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = load_json(BENCH / "configs" / f"{cell['config']}.json")
    traffic = load_json(BENCH / "traffic" / f"{name}.json")
    return spec, cell, config, traffic


def cell_metrics(spec: dict, cell: str) -> tuple[list, list]:
    """The end-to-end and per-layer metrics a cell reports."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if m["moves"] in names
             and cell in m.get("workloads", [cell])]
    return e2e, layer


def reader(metric: str):
    path = BENCH / "metrics" / f"{metric}.py"
    mod_name = "bench.metrics._" + metric.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _snapshot(svc) -> tuple[dict, dict, dict]:
    from repro_torch.kernels import launch_counts
    cache = {k: v for k, v in svc.cache.stats().items()
             if isinstance(v, int)}
    return svc.ledger.by_cause(), cache, launch_counts()


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()}


def end_to_end(queries: list, window_s: float, setup_s: float) -> dict:
    """The host-clock metrics of every completed query of the window."""
    done = [q for q in queries if q.error is None]
    lat = sorted(q.latency_s for q in done)
    out = {"setup_s": setup_s,
           "input_Mrows_per_s": sum(q.rows for q in done) / window_s / 1e6}
    if len(lat) >= 2:
        out["query_p90_ms"] = 1e3 * statistics.quantiles(
            lat, n=10, method="inclusive")[8]
    return out


def log_queries(queries: list, t0: float, log) -> None:
    """Latency by query and plan, and the slowest queries, for the run's
    log."""
    groups: dict = {}
    done = [q for q in queries if q.error is None]
    for q in done:
        groups.setdefault((q.kind, q.plan), []).append(q.latency_s)
    for (kind, plan), lat in sorted(groups.items()):
        lat.sort()
        log(f"  {kind} {plan}: {len(lat)} queries, ms min "
            f"{1e3 * lat[0]:.3f} median {1e3 * statistics.median(lat):.3f} "
            f"max {1e3 * lat[-1]:.3f}")
    for q in sorted(done, key=lambda q: -q.latency_s)[:SLOWEST]:
        log(f"  slow: at {q.t_submit - t0:.3f} s, {1e3 * q.latency_s:.3f} "
            f"ms, {q.kind} " + "; ".join(
                f"queued {1e3 * s.queued_s:.1f} wall {1e3 * s.wall_s:.1f} "
                + " ".join(f"{k} {1e3 * v:.1f}" for k, v in s.phase_s.items())
                for s in q.stages))


def log_device(svc, dev, log) -> None:
    """Allocator retries and the service's recovery counters."""
    res = svc.stats()["resilience"]
    log("  service: " + ", ".join(f"{k} {v}" for k, v in res.items()
                                  if isinstance(v, int) and v))
    if dev.type == "cuda":
        m = torch.cuda.memory_stats(dev)
        log(f"  allocator: retries {m.get('num_alloc_retries')}, ooms "
            f"{m.get('num_ooms')}, reserved peak "
            f"{m.get('reserved_bytes.all.peak')}, allocated peak "
            f"{m.get('allocated_bytes.all.peak')}")


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device="cuda", control: bool = False,
        config_override=None, spec=None, log=None) -> dict:
    """One run; returns the result line's object.  Tests may pass their
    own ``spec`` (for a BENCHMARK.json entry not yet made) and a
    ``config_override`` that edits the configuration and traffic."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    spec, cell, config, traffic = cell_spec(cell_name, spec)
    if config_override is not None:
        config_override(config, traffic)
    e2e_metrics, layer_metrics = cell_metrics(spec, cell_name)
    driver_mod = importlib.import_module(f"bench.drivers.{traffic['driver']}")
    driver = driver_mod.Driver(config, traffic, seed, device, log=log)
    dev = torch.device(device)
    driver.setup()
    svc = driver.svc
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    before = _snapshot(svc)
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    try:
        with (torch.profiler.record_function(WINDOW) if trace
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            queries = driver.window(seconds)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    window_s = t1 - t0
    ledger, cache, launches = (_delta(a, b) for a, b in
                               zip(_snapshot(svc), before))
    spans = [s for s in svc.tracer.spans() if s.t0 >= t0]
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    failed = sum(q.error is not None for q in queries)
    log(f"window {window_s:.3f} s: {len(queries)} queries, {failed} failed")
    for q in queries:
        if q.error is not None:
            log(f"  failed: {q.error}")
    log_queries(queries, t0, log)
    log_device(svc, dev, log)

    result = {"correct": False, "attempted": len(queries), "failed": failed}
    metrics, breakdown, device_block = {}, None, {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if trace:
        dtrace = DeviceTrace.from_profile(prof, t0)
        prof = None
        readings = Readings([q for q in queries if q.error is None], spans,
                            ledger, cache, launches, dtrace)
        units = {m["name"]: m["unit"] for m in layer_metrics}
        for m in layer_metrics:
            try:
                value = reader(m["name"])(readings)
            except Exception as e:     # the metric is left out, and said why
                log(f"{m['name']}: {e!r}")
                continue
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": units[m["name"]]}
        device_block["busy_s"] = dtrace.busy_s
        device_block["window_s"] = dtrace.window_s
        labels = [(s.name, s.t0, s.t1) for s in spans if s.lane is None]
        labels += [(f"bench.{k}", a, b) for q in queries
                   for k, (a, b) in q.spans.items()]
        breakdown = {"device_ops": dtrace.device_ops(),
                     "idle_gaps": dtrace.idle_gaps(labels)}
    else:
        values = end_to_end(queries, window_s, setup_s)
        for m in e2e_metrics:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}

    driver.release()
    del svc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    compared = driver.compared(queries, control=control)
    log(f"check {time.perf_counter() - t_check:.3f} s")
    checked = compared.get("answers_checked", (0, None))[0]
    result["correct"] = bool(checked > 0 and all(
        limit is None or value <= limit
        for value, limit in compared.values()))
    result["metrics"] = metrics
    result["device"] = device_block
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in compared.items()}
    for k, (v, lim) in compared.items():
        log(f"compared {k} {v} limit {lim}")
    return result
