"""Plain KZG commitments for an SRS whose secret s is known.

With the basis [s^i] G1, the commitment of p(X) = sum_i c_i X^i is
sum_i c_i [s^i] G1 = [p(s)] G1: one polynomial evaluation mod r and one
scalar multiplication of the generator, whatever the number of points.
"""
from __future__ import annotations

import operator
from typing import List, Sequence

from . import bn254 as C


def evaluate(coeffs: Sequence[int], s: int) -> int:
    """p(s) mod r by Horner's rule."""
    acc = 0
    s %= C.R
    for c in reversed(coeffs):
        acc = (acc * s + c) % C.R
    return acc


def powers(s: int, n: int) -> List[int]:
    """s^i mod r for i < n."""
    out = [1] * n
    s %= C.R
    for i in range(1, n):
        out[i] = out[i - 1] * s % C.R
    return out


def evaluate_at(coeffs: Sequence[int], pows: Sequence[int]) -> int:
    """p(s) mod r from the powers of s (`powers`), as one sum of products."""
    if len(coeffs) > len(pows):
        raise ValueError(f"{len(coeffs)} coefficients, {len(pows)} powers")
    return sum(map(operator.mul, coeffs, pows)) % C.R


def commitment(value_at_s: int):
    """[p(s)] G1 as an affine point (None for the identity)."""
    return C.mul(C.G1, value_at_s)
