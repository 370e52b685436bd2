"""h_host_s.prove: a proof's host seconds around the device h module, the
h_pack_inputs and h_unpack spans; the median over the window's proofs."""
from statistics import median

SPANS = ("h_pack_inputs", "h_unpack")


def read(record):
    per = [sum(r["totals"][s] for s in SPANS)
           for r in record.tracer.requests if all(s in r["totals"] for s in SPANS)]
    return median(per) if per else None
