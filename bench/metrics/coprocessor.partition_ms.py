"""coprocessor.partition_ms: mean PHJ ``partition`` phase, ms
(``Timing.phase_s``, closed after the groups' synchronize)."""
from bench.records import Readings


def read(r: Readings):
    d = [s.phase_s["partition"] for q in r.queries for s in q.stages
         if "partition" in s.phase_s]
    return 1e3 * sum(d) / len(d) if d else None
