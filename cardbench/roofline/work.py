"""The least work of the two device computations the benchmark reads, counted
from the inputs' shapes and values and never from the kernels that ran, so
that a route change or a new kernel is read against the same work.

h, the quotient of a PLONK proof (`h_shape`, `h_least_seconds`): per input
column an inverse NTT of n points, the coset shift (n products) and an NTT
of the extended size; per extended row the circuit's expression products
(gates with repeated subexpressions counted once, the permutation's chunks,
the lookups' terms) and one product an expression for the fold by y; then
an inverse NTT of h over the extended rows and its division by the
vanishing polynomial (two products a row).  Bytes: the input columns read
once, the fixed, sigma and Lagrange-selector columns read once at the
extended size, h and the advice coefficients written once.  An NTT of m
points is (m / 2) log2 m products.

A Pippenger MSM at a fixed reference of WINDOW_BITS = 15 (`msm_least_seconds`):
one mixed addition, 64 bytes read, for each (point, window) whose digit is
nonzero, and the window reduction's 2 * windows * 2^c Jacobian additions
over the windows' buckets of 96 bytes; the two bounds added.
"""
from __future__ import annotations

import numpy as np

from .peaks import (FIELD_BYTES, JAC_ADD_PRODUCTS, MIXED_ADD_PRODUCTS,
                    MONT_MADS, least_seconds)

WINDOW_BITS = 15
SCALAR_BITS = 254


def _ntt_products(m: int) -> int:
    return (m // 2) * (m.bit_length() - 1)


def expression_products(nodes) -> int:
    """Products and scalings in expression trees given as nested lists,
    each distinct subtree counted once."""
    seen = set()

    def walk(node):
        key = repr(node)
        if key in seen:
            return 0
        seen.add(key)
        count = 1 if node[0] in ("prod", "scaled") else 0
        return count + sum(walk(c) for c in node[1:] if isinstance(c, list))

    return sum(walk(n) for n in nodes)


def h_shape(key: dict) -> dict:
    """The shape of one circuit's h computation, from the verifier's key
    (reference/plonk_verify.py)."""
    n = key["n"]
    ext = n
    while ext < n * key["quotient_pieces"]:
        ext *= 2
    chunk = key["cs_degree"] - 2
    ncols = len(key["permutation_columns"])
    nsets = -(-ncols // chunk) if ncols else 0
    nlk = len(key["static_lookups"])
    row = expression_products(key["gates"])
    row += 2 * ncols + nsets + 3 + 2 * nlk
    expressions = len(key["gates"]) + (2 + nsets if nsets else 0) + nlk
    inputs = key["num_advice"] + key["num_instance"] + nsets + 2 * nlk
    resident = len(key["fixed_values"]) + len(key["sigma_values"]) + 3
    return {"n": n, "ext": ext, "row_products": row + expressions,
            "input_columns": inputs, "resident_columns": resident,
            "advice_columns": key["num_advice"]}


def h_least_seconds(shape: dict) -> float:
    n, ext = shape["n"], shape["ext"]
    products = shape["input_columns"] * (
        _ntt_products(n) + n + _ntt_products(ext))
    products += ext * shape["row_products"]
    products += _ntt_products(ext) + 2 * ext
    nbytes = FIELD_BYTES * (shape["input_columns"] * n
                            + shape["resident_columns"] * ext
                            + ext + shape["advice_columns"] * n)
    return least_seconds(nbytes, products * MONT_MADS)


def live_digits(limbs: np.ndarray, c: int = WINDOW_BITS) -> int:
    """Nonzero c-bit digits of scalars given as (m, 4) little-endian uint64
    words."""
    words = np.concatenate([limbs, np.zeros((limbs.shape[0], 1), np.uint64)], 1)
    mask = np.uint64((1 << c) - 1)
    live = 0
    for w in range(-(-SCALAR_BITS // c)):
        off = w * c
        lo, sh = divmod(off, 64)
        d = words[:, lo] >> np.uint64(sh)
        if sh + c > 64:
            d |= words[:, lo + 1] << np.uint64(64 - sh)
        live += int(np.count_nonzero(d & mask))
    return live


def scalar_live_digits(v: int, c: int = WINDOW_BITS) -> int:
    mask = (1 << c) - 1
    return sum(1 for w in range(-(-SCALAR_BITS // c)) if (v >> (w * c)) & mask)


def msm_least_seconds(live: int, c: int = WINDOW_BITS) -> float:
    nw, m = -(-SCALAR_BITS // c), 1 << c
    buckets = least_seconds(64 * live, live * MIXED_ADD_PRODUCTS * MONT_MADS)
    reduce = least_seconds(96 * nw * m,
                           2 * nw * m * JAC_ADD_PRODUCTS * MONT_MADS)
    return buckets + reduce
