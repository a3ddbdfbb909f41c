"""coprocessor.join_build_device_ms: device time of the join phase's
build per execution, ms: the ``device_s`` of ``join.build`` spans (R's
bucket ids and the table, b2-b4), between CUDA events on the card's
stream.  Nothing on a CPU G group."""
from bench.records import Readings
from bench.spans import device_time, mean_ms, per_execution


def read(r: Readings):
    return mean_ms(per_execution(r.spans, ("join.build",), device_time))
