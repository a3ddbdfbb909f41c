"""table_cache.fingerprint_pull_ms: the ``fingerprint.pull`` spans per
execution, ms: the ``.cpu()`` copies of both columns of a relation the
fingerprint memo missed.  An execution with none counts 0, so a window
whose fingerprints all hit the memo reads 0; a window with no
``fingerprint`` span reads nothing."""
from bench.records import Readings
from bench.spans import mean_ms, per_execution


def read(r: Readings):
    return mean_ms(per_execution(r.spans, ("fingerprint.pull",),
                                 present=("fingerprint",)))
