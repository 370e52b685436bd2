"""msm_scalars_s.commit: a commitment's seconds in the span msm_scalars (the
scalars reduced mod r and packed by fr_buf), from the program's span log;
the median over the window's commitments (cardbench/commit_log.py)."""
from cardbench import commit_log


def read(record):
    return commit_log.span_seconds(record, "msm_scalars")
