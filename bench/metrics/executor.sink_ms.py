"""executor.sink_ms: a pipeline's sink per query, ms: the mean ``sink``
span of ``PipelineExecutor._finish`` (``kind`` scalar or grouped), from
the view's rows to the answer, the group-by's own ``query`` span
included.  None for a program that records no such span."""
from bench.records import Readings


def read(r: Readings):
    d = [s.t1 - s.t0 for s in r.spans if s.name == "sink" and s.lane is None]
    return 1e3 * sum(d) / len(d) if d else None
