"""executor.scan_fp_ms: the SHA-1 of base columns per completed query,
ms: the ``scan.fp`` spans of ``_ScanView.col_fp`` (one a memo miss),
summed over the window.  None for a program that records no such span."""
from bench.records import Readings


def read(r: Readings):
    d = [s.t1 - s.t0 for s in r.spans
         if s.name == "scan.fp" and s.lane is None]
    if not d or not r.queries:
        return None
    return 1e3 * sum(d) / len(r.queries)
