"""coprocessor.join_ms: join phases per query, ms: the PHJ ``join``
phase, or SHJ ``build`` plus ``probe``, summed over a query's stages
(each closed after the groups' synchronize), averaged over queries."""
from bench.records import Readings

PHASES = ("join", "build", "probe")


def read(r: Readings):
    per = [sum(s.phase_s.get(p, 0.0) for s in q.stages for p in PHASES)
           for q in r.queries]
    return 1e3 * sum(per) / len(per) if per else None
