"""Plain KZG commitments to polynomials in Lagrange form, for an SRS whose
secret s is known.

Over the domain of the n-th roots of unity (omega of order n), the
Lagrange basis at s is L_i(s) = (s^n - 1)/n * omega^i / (s - omega^i), and
the commitment of the values v_i is sum_i v_i [L_i(s)] G1 =
[sum_i v_i L_i(s)] G1: one sum of products mod r and one scalar
multiplication of the generator, whatever the number of rows.
"""
from __future__ import annotations

import operator
from typing import List, Sequence

import numpy as np

from . import bn254 as C


def lagrange_at(s: int, n: int) -> List[int]:
    """L_i(s) mod r for i < n, n a power of two; s may not be a root of
    unity of order n."""
    k = n.bit_length() - 1
    if n != 1 << k:
        raise ValueError(f"the domain size {n} is not a power of two")
    s %= C.R
    omega = C.root_of_unity(k)
    w = [1] * n
    for i in range(1, n):
        w[i] = w[i - 1] * omega % C.R
    denoms = [(s - wi) % C.R for wi in w]
    if 0 in denoms:
        raise ValueError("s is a root of unity of the domain")
    scale = (pow(s, n, C.R) - 1) * C.inv(n) % C.R
    return [scale * wi % C.R * d % C.R
            for wi, d in zip(w, C.batch_inv(denoms))]


def evaluate(values: Sequence[int], lag: Sequence[int]) -> int:
    """sum_i v_i L_i(s) mod r."""
    if len(values) != len(lag):
        raise ValueError(f"{len(values)} values, {len(lag)} basis values")
    return sum(map(operator.mul, values, lag)) % C.R


def evaluate_words(words: np.ndarray, lag: Sequence[int]) -> int:
    """evaluate() of values given as (n, 4) little-endian uint64 words: a
    sum of products a word position, over the rows where that word is not
    zero."""
    if words.shape != (len(lag), 4):
        raise ValueError(f"words {words.shape} for {len(lag)} basis values")
    acc = 0
    for j in range(4):
        rows = np.flatnonzero(words[:, j])
        if rows.size == 0:
            continue
        sel = lag if rows.size == len(lag) else [lag[i] for i in rows.tolist()]
        acc += sum(map(operator.mul, words[rows, j].tolist(), sel)) << (64 * j)
    return acc % C.R


def commitment(value_at_s: int):
    """[value] G1 as an affine point (None for the identity)."""
    return C.mul(C.G1, value_at_s)
