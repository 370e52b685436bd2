"""h2d_bytes.witness: a witness commitment's host-to-device bytes, the count
h2d_bytes summed over its spans, from the program's span log; the median
over the window's commitments (cardbench/commit_many_log.py)."""
from cardbench import commit_many_log


def read(record):
    return commit_many_log.count(record, "h2d_bytes")
