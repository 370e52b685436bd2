"""cq_s.prove: a proof's seconds in the CQ static lookups' two phases,
create_proof/cq_commit_f_m and create_proof/cq_log_derivatives; the median
over the window's proofs."""
from statistics import median

MARKS = ("create_proof/cq_commit_f_m", "create_proof/cq_log_derivatives")


def read(record):
    per = [sum(r["totals"][m] for m in MARKS)
           for r in record.tracer.requests if all(m in r["totals"] for m in MARKS)]
    return median(per) if per else None
