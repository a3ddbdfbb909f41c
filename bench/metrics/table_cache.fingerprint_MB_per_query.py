"""table_cache.fingerprint_MB_per_query: MB the service pulled from the
card to fingerprint relations, per completed query (the transfer
ledger's ``fingerprint`` cause over the window)."""
from bench.records import Readings


def read(r: Readings):
    if not r.queries:
        return None
    return r.ledger.get("fingerprint", 0) / 1e6 / len(r.queries)
