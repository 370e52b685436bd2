"""The least work of the CQ tables' cached quotients by Feist-Khovratovich
(`fk_least_seconds`), counted from the rows N and the columns alone, never
from the kernels that ran, so that any route is read against the same
work.

A column of N rows takes a group NTT of 2N points and one of N, and two
rows of per-point scalings (t_hat B_hat over 2N points, w^i / N over N).
Each non-trivial twiddle of a size-m group NTT, (m / 2) log2 m - (m - 1)
of them, and each per-point scaling count as one scalar multiplication at
its floor: the 127 doublings of a GLV half-scalar at 7 products each, no
additions.  Add the column's table NTTs, an inverse NTT of N points and an
NTT of 2N, at (m / 2) log2 m products each.  Bytes: each column's values in
and quotients out, and the SRS side read once.  The floor is low on
purpose, so that no route reads above 100%.
"""
from __future__ import annotations

from .peaks import FIELD_BYTES, MONT_MADS, least_seconds

GLV_DOUBLINGS = 127
DOUBLING_PRODUCTS = 7
POINT_BYTES = 3 * FIELD_BYTES          # a Jacobian point


def ntt_products(m: int) -> int:
    return (m // 2) * (m.bit_length() - 1)


def nontrivial_twiddles(m: int) -> int:
    return (m // 2) * (m.bit_length() - 1) - (m - 1)


def fk_scalar_muls(n: int, cols: int) -> int:
    return cols * (nontrivial_twiddles(2 * n) + nontrivial_twiddles(n)
                   + 2 * n + n)


def fk_products(n: int, cols: int) -> int:
    return fk_scalar_muls(n, cols) * GLV_DOUBLINGS * DOUBLING_PRODUCTS + \
        cols * (ntt_products(n) + ntt_products(2 * n))


def fk_bytes(n: int, cols: int) -> int:
    return cols * n * 3 * FIELD_BYTES + 2 * n * POINT_BYTES


def fk_least_seconds(n: int, cols: int) -> float:
    return least_seconds(fk_bytes(n, cols), fk_products(n, cols) * MONT_MADS)
