"""executor.scan_upload_MB_per_query: MB of base-table columns the scan
views uploaded to the card, per completed query (the transfer ledger's
``scan_upload`` cause over the window).  None for a program whose ledger
has no such cause."""
from bench.records import Readings


def read(r: Readings):
    if "scan_upload" not in r.ledger or not r.queries:
        return None
    return r.ledger["scan_upload"] / 1e6 / len(r.queries)
