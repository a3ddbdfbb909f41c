"""table_cache.fingerprint_ms: the service's ``fingerprint`` spans per
execution, ms: both sides' cache keys, at admission (on the client's
thread) and in the query, memo hits and structural keys included."""
from bench.records import Readings
from bench.spans import mean_ms, per_execution


def read(r: Readings):
    return mean_ms(per_execution(r.spans, ("fingerprint",)))
