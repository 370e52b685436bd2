"""host_protocol_s.prove: a proof's seconds in create_proof's host phases,
every create_proof/* mark but h_eval_and_commit; the median over the
window's proofs."""
from statistics import median


def read(record):
    per = [sum(v for k, v in r["totals"].items()
               if k.startswith("create_proof/") and k.count("/") == 1
               and k != "create_proof/h_eval_and_commit")
           for r in record.tracer.requests]
    return median(per) if per and any(per) else None
