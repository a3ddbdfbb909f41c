"""optimizer.optimize_ms: ``JoinOrderOptimizer.optimize`` per query, ms
(the benchmark's own span around the call)."""
from bench.records import Readings


def read(r: Readings):
    d = [q.spans["optimize"][1] - q.spans["optimize"][0]
         for q in r.queries if "optimize" in q.spans]
    return 1e3 * sum(d) / len(d) if d else None
