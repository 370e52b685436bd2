"""The yardstick's counts against small cases worked out by hand."""
import pytest

from cardbench.reference import bn254
from cardbench.roofline import peaks, work


def test_peaks():
    assert peaks.IMAD_PER_S == pytest.approx(132 * 64 * 1.98e9, rel=2e-3)
    assert peaks.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 16.75e12) == pytest.approx(1.0)


def test_h_least_seconds_by_hand():
    # n = 4, ext = 8: per input column an iNTT of 4 (4 products), the
    # shift (4) and an NTT of 8 (12): 20, two columns 40; 3 products a row
    # over 8 rows, 24; the h iNTT (12) and 2 a row (16): 92 products.
    # Bytes: 32 x (2 x 4 inputs + 1 x 8 resident + 8 h + 1 x 4 advice).
    shape = {"n": 4, "ext": 8, "row_products": 3, "input_columns": 2,
             "resident_columns": 1, "advice_columns": 1}
    want = max(32 * 28 / 3.35e12, 92 * 264 / 16.75e12)
    assert work.h_least_seconds(shape) == pytest.approx(want)


def test_h_shape_counts():
    key = {"n": 8, "quotient_pieces": 2, "cs_degree": 3,
           "permutation_columns": [["advice", 0], ["advice", 1], ["instance", 0]],
           "static_lookups": [["t"]], "num_advice": 2, "num_instance": 1,
           "fixed_values": [[0] * 8], "sigma_values": [[0] * 8] * 3,
           "gates": [["prod", ["advice", 0], ["advice", 1]],
                     ["sum", ["prod", ["advice", 0], ["advice", 1]],
                      ["scaled", ["fixed", 0], 5]]]}
    shape = work.h_shape(key)
    # gates: one distinct product and one scaling (2); permutation: 2 a
    # column (6), one a set (3 sets), 3 boundary terms; CQ 2; one fold
    # product an expression: 2 gates + 2 + 3 sets + 1 lookup = 8
    assert shape["row_products"] == 2 + 6 + 3 + 3 + 2 + 8
    assert shape["ext"] == 16
    assert shape["input_columns"] == 2 + 1 + 3 + 2
    assert shape["resident_columns"] == 1 + 3 + 3


def test_expression_products_counts_repeats_once():
    p = ["prod", ["advice", 0], ["advice", 1]]
    assert work.expression_products([p, ["sum", p, ["scaled", p, 3]]]) == 2


def test_live_digits_by_hand():
    import numpy as np
    vals = [0, 1, 1 << 15, (1 << 15) - 1 + (5 << 240), bn254.R - 1]
    limbs = np.array([[(v >> (64 * j)) & (2 ** 64 - 1) for j in range(4)]
                      for v in vals], dtype=np.uint64)
    # R - 1: every 15-bit window of it is nonzero but one? count directly
    r_live = sum(1 for w in range(17) if ((bn254.R - 1) >> (15 * w)) & 0x7FFF)
    assert work.live_digits(limbs) == 0 + 1 + 1 + 2 + r_live
    assert [work.scalar_live_digits(v) for v in vals[:4]] == [0, 1, 1, 2]


def test_msm_least_seconds_by_hand():
    live, nw, m = 10, 17, 1 << 15
    want = (max(64 * live / 3.35e12, live * 11 * 264 / 16.75e12)
            + max(96 * nw * m / 3.35e12, 2 * nw * m * 16 * 264 / 16.75e12))
    assert work.msm_least_seconds(live) == pytest.approx(want)
    # 2^20 uniform scalars: about 17 windows each live
    assert work.msm_least_seconds(17 * 2 ** 20) * 1e3 == pytest.approx(3.39, abs=0.05)
