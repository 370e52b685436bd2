"""msm_host_s.witness: a witness commitment's seconds on the host clock, the
benchmark's span around the request's commit_lagrange_many less the
device's busy time inside it; the median over the window's commitments."""
from statistics import median


def read(record):
    t = record.tracer
    if t.busy is None:
        return None
    per = [(e - s) - t.busy_within(s, e) for s, e in record.window.spans]
    return median(per) if per else None
