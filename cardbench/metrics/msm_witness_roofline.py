"""msm_witness_roofline: the least time of the window's witness MSMs as a
Pippenger at the reference's 15 window bits, counted from their columns'
nonzero digits (roofline/work.py), over the device's busy time inside the
commitments' spans, in percent."""
from cardbench.roofline import work


def read(record):
    t, state = record.tracer, record.state
    if t.busy is None:
        return None
    busy = sum(t.busy_within(s, e) for s, e in record.window.spans)
    if busy <= 0:
        return None
    least = sum(work.msm_least_seconds(live) for live in state.live)
    return 100.0 * least / busy
