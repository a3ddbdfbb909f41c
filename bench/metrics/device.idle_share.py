"""device.idle_share: share of the traced window with no kernel, copy or
set running on the card, % (``torch.profiler``)."""
from bench.records import Readings


def read(r: Readings):
    if r.device is None or r.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.device.busy_s / r.device.window_s)
