"""fk_readback_s.tables: a table's seconds in the span cq_readback (the
quotients made affine on the device, copied to the host and made into the
answer's points), from the program's span log; the median over the
window's tables (cardbench/cq_fk_log.py)."""
from cardbench import cq_fk_log


def read(record):
    return cq_fk_log.span_seconds(record, "cq_readback")
