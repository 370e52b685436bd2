"""h2d_bytes.tables: a table's host-to-device bytes (its values going up,
and the SRS on a B_hat fill), the count h2d_bytes summed over its spans,
from the program's span log; the median over the window's tables
(cardbench/cq_fk_log.py)."""
from cardbench import cq_fk_log


def read(record):
    return cq_fk_log.count(record, "h2d_bytes")
