"""h_device_s.prove: a proof's seconds in the h_device span (the device h
module, ended by a synchronise); the median over the window's proofs."""
from statistics import median


def read(record):
    per = [r["totals"]["h_device"] for r in record.tracer.requests
           if "h_device" in r["totals"]]
    return median(per) if per else None
