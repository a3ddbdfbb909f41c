"""coprocessor.expand_warp_max_pairs: the longest rid list the CSR
expand wrote for one probe tuple, pairs: the largest ``warp_max_pairs``
on an execution's ``join.expand`` spans, averaged over the window's
executions (those whose spans carry it).  On the card a list longer
than 8 is written by one warp, 32 slots a round.  Nothing from a program
without the counts."""
from bench.records import Readings


def read(r: Readings):
    executions, longest = set(), {}
    for s in r.spans:
        key = s.attrs.get("q_key")
        if key is None or s.lane is not None:
            continue
        if s.name == "query":
            executions.add(key)
        elif s.name == "join.expand" and "warp_max_pairs" in s.attrs:
            longest[key] = max(longest.get(key, 0), s.attrs["warp_max_pairs"])
    found = [v for k, v in longest.items() if k in executions]
    return sum(found) / len(found) if found else None
