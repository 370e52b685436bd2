"""h_roofline: the least time of the window's h computations, counted from
the key's shapes (roofline/work.py), over the device's busy time inside
their h_device spans, in percent."""
from cardbench.roofline import work


def read(record):
    t = record.tracer
    if t.busy is None:
        return None
    spans = t.spans("h_device")
    busy = sum(t.busy_within(s, e) for s, e in spans)
    if not spans or busy <= 0:
        return None
    least = len(spans) * work.h_least_seconds(record.state.work)
    return 100.0 * least / busy
