"""Plain CQ cached quotients of a table column, from their definition (CQ,
Eagen-Fiore-Gabizon, eprint 2022/1763, section 3), in Python integers; it
imports nothing of the program under test and shares nothing with FK.

For a column t_0..t_{N-1} over the N-th roots of unity w^i, T(X) its
interpolant and s the SRS's secret, the cached quotient of row i is

    qs[i] = [ (T(s) - t_i) / (s - w^i) * w^i / N ]_1 = c_i G1,

T(s) = sum_j t_j L_j(s), L_j(s) = (s^N - 1) / N * w^j / (s - w^j) (s is
not a root of unity).  `quotient_scalars` gives every c_i;
`combination_holds` checks a whole answer against them at the cost of one
multi-scalar multiplication with short weights, and `rows_hold` checks
chosen rows point for point.
"""
from __future__ import annotations

import hashlib
from typing import List, Sequence

from . import bn254

WEIGHT_BITS = 64


def quotient_scalars(values: Sequence[int], s: int) -> List[int]:
    """c_i = (T(s) - t_i) w^i / (N (s - w^i)) for every row i."""
    n = len(values)
    omega = bn254.root_of_unity(n.bit_length() - 1)
    pows = [1] * n
    for i in range(1, n):
        pows[i] = pows[i - 1] * omega % bn254.R
    invs = bn254.batch_inv([(s - w) % bn254.R for w in pows])
    n_inv = bn254.inv(n)
    zn = (pow(s, n, bn254.R) - 1) * n_inv % bn254.R
    t_s = sum(v % bn254.R * w % bn254.R * d for v, w, d in
              zip(values, pows, invs)) * zn % bn254.R
    return [(t_s - v) * w % bn254.R * d % bn254.R * n_inv % bn254.R
            for v, w, d in zip(values, pows, invs)]


def draw(tag, i: int) -> int:
    """The i-th 256-bit draw of the stream named `tag` (SHA-256 of both)."""
    return int.from_bytes(hashlib.sha256(f"{tag}:{i}".encode()).digest(),
                          "little")


def weights(seed, n: int) -> List[int]:
    """n nonzero WEIGHT_BITS-bit weights drawn from `seed`."""
    return [draw(seed, i) % ((1 << WEIGHT_BITS) - 1) + 1 for i in range(n)]


def rows(seed, n: int, count: int = 64) -> List[int]:
    """min(count, n) distinct rows below n drawn from `seed`."""
    out, i = [], 0
    while len(out) < min(count, n):
        r = draw(f"rows:{seed}", i) % n
        if r not in out:
            out.append(r)
        i += 1
    return out


def msm_short(terms, bits: int = WEIGHT_BITS, c: int = 12):
    """sum k_i P_i for affine P_i (None: the identity) and k_i < 2^bits, by
    the bucket method with c-bit windows, in Jacobian coordinates."""
    pts = [(k, bn254.to_jac(p)) for k, p in terms if p is not None and k]
    total = bn254.INF
    mask = (1 << c) - 1
    for w in range((bits + c - 1) // c - 1, -1, -1):
        for _ in range(c):
            total = bn254.jac_double(total)
        buckets = [bn254.INF] * (1 << c)
        for k, p in pts:
            d = (k >> (w * c)) & mask
            if d:
                buckets[d] = bn254.jac_add(buckets[d], p)
        run = acc = bn254.INF
        for d in range(mask, 0, -1):
            run = bn254.jac_add(run, buckets[d])
            acc = bn254.jac_add(acc, run)
        total = bn254.jac_add(total, acc)
    return bn254.to_affine(total)


def combination_holds(points: Sequence, scalars: Sequence[int], seed) -> bool:
    """sum_i r_i points[i] == (sum_i r_i c_i) G1 for WEIGHT_BITS-bit weights
    r_i drawn from `seed`: a wrong point passes with probability about
    2^-64 (r_i enters only through its residue's product with the error)."""
    if len(points) != len(scalars):
        return False
    r = weights(seed, len(points))
    want = sum(a * b for a, b in zip(r, scalars)) % bn254.R
    return msm_short(zip(r, points)) == bn254.mul(bn254.G1, want)


def rows_hold(points: Sequence, scalars: Sequence[int], rows) -> bool:
    """points[i] == c_i G1 for each row i of `rows`."""
    return all(points[i] == bn254.mul(bn254.G1, scalars[i]) for i in rows)


def check_column(job) -> bool:
    """One column's whole answer against its definition: (values, points,
    secret, tag) -> whether the combination with weights drawn from `tag`
    holds and 64 rows drawn from `tag` hold point for point."""
    values, points, s, tag = job
    c = quotient_scalars(values, s)
    return len(points) == len(values) and \
        combination_holds(points, c, f"weights:{tag}") and \
        rows_hold(points, c, rows(tag, len(values)))
