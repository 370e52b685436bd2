"""h2d_bytes.commit: a commitment's host-to-device bytes, the count h2d_bytes
summed over its spans, from the program's span log; the median over the
window's commitments (cardbench/commit_log.py)."""
from cardbench import commit_log


def read(record):
    return commit_log.count(record, "h2d_bytes")
