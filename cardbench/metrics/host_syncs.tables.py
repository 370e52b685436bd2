"""host_syncs.tables: the times a table's host waited for the card, the
count host_syncs summed over its spans, from the program's span log; the
median over the window's tables (cardbench/cq_fk_log.py)."""
from cardbench import cq_fk_log


def read(record):
    return cq_fk_log.count(record, "host_syncs")
