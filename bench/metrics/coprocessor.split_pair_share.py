"""coprocessor.split_pair_share: share of the pairs the CSR expand wrote
through its split path (rid lists longer than ``SPLIT`` = 2048, queued by
the first kernel and cut across the blocks of the second), %: the
``split_pairs`` over the ``pairs`` counted on the window's executions'
``join.expand`` spans.  Nothing from a program without the counts."""
from bench.records import Readings
from bench.spans import per_execution


def _count(name):
    return lambda s: s.attrs.get(name)


def read(r: Readings):
    pairs = per_execution(r.spans, ("join.expand",), _count("pairs"))
    split = per_execution(r.spans, ("join.expand",), _count("split_pairs"))
    if pairs is None or split is None or sum(pairs) <= 0:
        return None
    return 100.0 * sum(split) / sum(pairs)
