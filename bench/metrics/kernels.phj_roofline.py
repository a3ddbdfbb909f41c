"""kernels.phj_roofline: the port's join kernels A-F against their
memory bound, % of the card's peak bandwidth.

Sum over every A-F launch of the window of bytes / 3.35 TB/s, over the
sum of their device time (``torch.profiler``, by kernel name).  Bytes
come from ``bench.roofline``: each query's launches are worked out from
its sizes and plan (``phj_query_launches``), and their count per kernel
has to equal the program's launch counters over the window, or the
launches cannot be attributed and the reading raises."""
from collections import Counter

from bench import roofline
from bench.records import Readings


def read(r: Readings):
    if r.device is None:
        return None
    launches = []
    for q in r.queries:
        for s in q.stages:
            if s.algorithm != "phj" or s.build_n is None:
                raise ValueError(f"no launch model for a {s.algorithm} "
                                 f"execution")
            launches += roofline.phj_query_launches(
                s.build_n, s.probe_n, s.schedule,
                partition_ratio=s.partition_ratio, join_ratio=s.join_ratio,
                build_layout_hit=s.build_layout_hit,
                probe_layout_hit=s.probe_layout_hit)
    model = Counter(k for k, _ in launches)
    counted = Counter({k: r.launches.get(c, 0)
                       for k, c in roofline.COUNTER_OF.items()})
    if +model != +counted:
        raise ValueError(f"launches not attributed: modelled {dict(model)}, "
                         f"counted {dict(counted)}")
    device_s = sum(s for name, s in r.device.kernels()
                   if roofline.kernel_letter(name))
    if not launches or device_s <= 0:
        return None
    bound = sum(roofline.bound_s(b) for _, b in launches)
    return 100.0 * bound / device_s
