"""msm_nonzero_digits.witness: the nonzero window digits K5 adds in a
witness commitment, the count msm_nonzero_digits summed over its spans,
from the program's span log; the median over the window's commitments
(cardbench/commit_many_log.py).  Against a uniform column's 18 a point it
shows the skew K5 sees."""
from cardbench import commit_many_log


def read(record):
    return commit_many_log.count(record, "msm_nonzero_digits")
