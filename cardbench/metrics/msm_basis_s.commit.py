"""msm_basis_s.commit: a commitment's seconds in the span msm_basis (the
packed basis cut into limbs and copied to the card), from the program's
span log; the median over the window's commitments
(cardbench/commit_log.py)."""
from cardbench import commit_log


def read(record):
    return commit_log.span_seconds(record, "msm_basis")
