"""msm_digits_s.witness: a witness commitment's seconds in the span
msm_digits (the column's u64 words copied to the card and cut into window
digits), from the program's span log; the median over the window's
commitments (cardbench/commit_many_log.py)."""
from cardbench import commit_many_log


def read(record):
    return commit_many_log.span_seconds(record, "msm_digits")
