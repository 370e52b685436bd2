"""fk_host_s.tables: a table's seconds on the host clock, the program's
cq_fk span (its batched preprocessing call) less the device's busy time
inside it; the median over the window's tables."""
from statistics import median


def read(record):
    t = record.tracer
    if t is None or t.busy is None:
        return None
    per = [(e - s) - t.busy_within(s, e) for s, e in t.spans("cq_fk")
           if any(a <= s and e <= b for a, b in record.window.spans)]
    return median(per) if per else None
