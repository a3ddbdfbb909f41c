"""coprocessor.join_probe_device_ms: device time of the join phase's
probe per execution, ms: the ``device_s`` of ``join.probe`` spans (S's
bucket ids, p2, p3, p4), between CUDA events on the card's stream.
Nothing on a CPU G group."""
from bench.records import Readings
from bench.spans import device_time, mean_ms, per_execution


def read(r: Readings):
    return mean_ms(per_execution(r.spans, ("join.probe",), device_time))
