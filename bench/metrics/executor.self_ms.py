"""executor.self_ms: ``PipelineExecutor.run``'s own time per query, ms.

The benchmark's span around ``run`` less the union of the service's
``query`` spans (the pipeline's stages and sink) inside it: the scan
views' SHA-1 of base columns, uploads, exact match counts and hand-off.
One client runs one pipeline at a time, so every ``query`` span inside
the ``run`` span is that pipeline's."""
from bench.intervals import covered
from bench.records import Readings


def read(r: Readings):
    runs = [q.spans["run"] for q in r.queries if "run" in q.spans]
    if not runs:
        return None
    stages = [(s.t0, s.t1) for s in r.spans
              if s.name == "query" and s.lane is None]
    selfs = [(b - a) - covered(stages, a, b) for a, b in runs]
    return 1e3 * sum(selfs) / len(selfs)
