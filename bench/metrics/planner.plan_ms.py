"""planner.plan_ms: mean ``plan`` span of the service, ms."""
from bench.records import Readings


def read(r: Readings):
    d = [s.t1 - s.t0 for s in r.spans if s.name == "plan" and s.lane is None]
    return 1e3 * sum(d) / len(d) if d else None
