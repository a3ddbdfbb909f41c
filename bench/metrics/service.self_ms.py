"""service.self_ms: the service's own time per execution, ms.

Per execution (one ``q_key`` of the service's tracer): its ``admit``
spans and its ``query`` span, each less the union of the spans nested in
it on its thread (``plan``, the co-processor's phases), summed; averaged
over the executions of the window.  The host fingerprints of both sides
and the cache lookups fall here."""
from collections import defaultdict

from bench.intervals import covered
from bench.records import Readings


def read(r: Readings):
    by_key = defaultdict(list)
    for s in r.spans:
        key = s.attrs.get("q_key")
        if key is not None and s.lane is None:
            by_key[key].append(s)
    selfs = []
    for spans in by_key.values():
        tops = [s for s in spans if s.name in ("admit", "query")]
        if not any(s.name == "query" for s in tops):
            continue
        total = 0.0
        for top in tops:
            inner = [(s.t0, s.t1) for s in spans
                     if s is not top and s.thread == top.thread
                     and s.t0 >= top.t0 and s.t1 <= top.t1]
            total += (top.t1 - top.t0) - covered(inner)
        selfs.append(total)
    return 1e3 * sum(selfs) / len(selfs) if selfs else None
