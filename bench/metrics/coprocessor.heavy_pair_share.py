"""coprocessor.heavy_pair_share: share of the pairs the CSR expand wrote
through its warp-wide path (rid lists longer than 8), %: the
``heavy_pairs`` over the ``pairs`` counted on the window's executions'
``join.expand`` spans.  Nothing from a program without the counts."""
from bench.records import Readings
from bench.spans import per_execution


def _count(name):
    return lambda s: s.attrs.get(name)


def read(r: Readings):
    pairs = per_execution(r.spans, ("join.expand",), _count("pairs"))
    heavy = per_execution(r.spans, ("join.expand",), _count("heavy_pairs"))
    if pairs is None or heavy is None or sum(pairs) <= 0:
        return None
    return 100.0 * sum(heavy) / sum(pairs)
