"""coprocessor.join_expand_device_ms: device time of the join phase's
expand per execution, ms: the ``device_s`` of ``join.expand`` spans (the
scan of the match counts and the CSR expand, inside ``join.probe``),
between CUDA events on the card's stream.  Nothing on a CPU G group, or
from a program without the span."""
from bench.records import Readings
from bench.spans import device_time, mean_ms, per_execution


def read(r: Readings):
    return mean_ms(per_execution(r.spans, ("join.expand",), device_time))
