"""host_syncs.commit: the times a commitment's host waited for the card, the
count host_syncs summed over its spans, from the program's span log; the
median over the window's commitments (cardbench/commit_log.py)."""
from cardbench import commit_log


def read(record):
    return commit_log.count(record, "host_syncs")
