"""coprocessor.partition_probe_device_ms: device time of the probe
relation's partition passes per execution, ms: the ``device_s`` of
``partition.probe`` spans (S's passes inside the ``partition`` phase,
between CUDA events on the G group's stream), 0 for an execution that
reused S's layout.  Nothing on a CPU G group, nor from a program without
the span."""
from bench.records import Readings
from bench.spans import device_time, mean_ms, per_execution


def read(r: Readings):
    return mean_ms(per_execution(r.spans, ("partition.probe",), device_time))
