"""fk_roofline: the least time of the window's cached quotients by FK,
counted from each served table's rows and columns (roofline/fk_work.py),
over the device's busy time inside the requests' spans, in percent."""
from cardbench.roofline import fk_work


def read(record):
    t = record.tracer
    if t is None or t.busy is None:
        return None
    busy = sum(t.busy_within(s, e) for s, e in record.window.spans)
    if busy <= 0 or not record.window.served:
        return None
    least = sum(fk_work.fk_least_seconds(len(ans[0]), len(ans))
                for _, ans in record.window.served)
    return 100.0 * least / busy
