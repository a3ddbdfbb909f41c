"""service.lock_wait_ms: the service's ``lock_wait`` spans per
execution, ms: waits for the device groups' execution locks (C, G),
which one query holds while another's join runs."""
from bench.records import Readings
from bench.spans import mean_ms, per_execution


def read(r: Readings):
    return mean_ms(per_execution(r.spans, ("lock_wait",)))
