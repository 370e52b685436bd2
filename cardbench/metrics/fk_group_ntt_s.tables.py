"""fk_group_ntt_s.tables: a table's seconds in the span cq_group_ntt (the
inverse group NTT of 2N points and the group NTT of N, waited for while the
profiler is on), from the program's span log; the median over the window's
tables (cardbench/cq_fk_log.py)."""
from cardbench import cq_fk_log


def read(record):
    return cq_fk_log.span_seconds(record, "cq_group_ntt")
