"""Plain BN254 arithmetic for the benchmark's references: the scalar field
Fr, the base field Fq and the group G1 (y^2 = x^3 + 3), in Python integers.

Written from the curve's published parameters (the same constants every
BN254 library states); it imports nothing of the program under test.
Points are affine (x, y) tuples, None for the identity; sums run in
Jacobian coordinates.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

R = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
Q = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47
B = 3
G1 = (1, 2)
# Fr's two-adicity and multiplicative generator: R - 1 = 2^28 * odd
TWO_ADICITY = 28
GENERATOR = 7

Affine = Optional[Tuple[int, int]]
Jac = Tuple[int, int, int]
INF: Jac = (1, 1, 0)


def inv(a: int, m: int = R) -> int:
    return pow(a, m - 2, m)


def batch_inv(values: Sequence[int], m: int = R) -> List[int]:
    """Inverses of nonzero values mod m with one exponentiation."""
    prefix, acc = [], 1
    for v in values:
        prefix.append(acc)
        acc = acc * v % m
    acc = inv(acc, m)
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        out[i] = acc * prefix[i] % m
        acc = acc * values[i] % m
    return out


def root_of_unity(k: int) -> int:
    """The generator of Fr's subgroup of order 2^k: GENERATOR^((R-1)/2^28)
    squared 28 - k times."""
    w = pow(GENERATOR, (R - 1) >> TWO_ADICITY, R)
    for _ in range(k, TWO_ADICITY):
        w = w * w % R
    return w


def delta() -> int:
    """GENERATOR^(2^28): the coset shift of the permutation argument."""
    return pow(GENERATOR, 1 << TWO_ADICITY, R)


# ---- G1 -------------------------------------------------------------------

def to_jac(p: Affine) -> Jac:
    return INF if p is None else (p[0], p[1], 1)


def jac_double(p: Jac) -> Jac:
    x, y, z = p
    if z == 0 or y == 0:
        return INF
    a = x * x % Q
    b = y * y % Q
    c = b * b % Q
    d = 2 * ((x + b) * (x + b) - a - c) % Q
    e = 3 * a % Q
    x3 = (e * e - 2 * d) % Q
    y3 = (e * (d - x3) - 8 * c) % Q
    z3 = 2 * y * z % Q
    return (x3, y3, z3)


def jac_add(p: Jac, q: Jac) -> Jac:
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = z1 * z1 % Q
    z2z2 = z2 * z2 % Q
    u1 = x1 * z2z2 % Q
    u2 = x2 * z1z1 % Q
    s1 = y1 * z2 * z2z2 % Q
    s2 = y2 * z1 * z1z1 % Q
    if u1 == u2:
        return jac_double(p) if s1 == s2 else INF
    h = (u2 - u1) % Q
    i = 4 * h * h % Q
    j = h * i % Q
    r = 2 * (s2 - s1) % Q
    v = u1 * i % Q
    x3 = (r * r - j - 2 * v) % Q
    y3 = (r * (v - x3) - 2 * s1 * j) % Q
    z3 = ((z1 + z2) * (z1 + z2) - z1z1 - z2z2) * h % Q
    return (x3, y3, z3)


def to_affine(p: Jac) -> Affine:
    if p[2] == 0:
        return None
    zi = inv(p[2], Q)
    zi2 = zi * zi % Q
    return (p[0] * zi2 % Q, p[1] * zi2 * zi % Q)


def mul(p: Affine, k: int) -> Affine:
    """k * p by double-and-add over the bits of k mod R."""
    k %= R
    acc, base = INF, to_jac(p)
    while k:
        if k & 1:
            acc = jac_add(acc, base)
        base = jac_double(base)
        k >>= 1
    return to_affine(acc)


def msm(terms: Iterable[Tuple[int, Affine]], c: int = 6) -> Affine:
    """sum k_i * P_i by the bucket method with c-bit windows."""
    pts = [(k % R, to_jac(p)) for k, p in terms if p is not None and k % R]
    if not pts:
        return None
    total = INF
    mask = (1 << c) - 1
    for w in range((R.bit_length() + c - 1) // c - 1, -1, -1):
        for _ in range(c):
            total = jac_double(total)
        buckets = [INF] * (1 << c)
        for k, p in pts:
            d = (k >> (w * c)) & mask
            if d:
                buckets[d] = jac_add(buckets[d], p)
        run = acc = INF
        for d in range(mask, 0, -1):
            run = jac_add(run, buckets[d])
            acc = jac_add(acc, run)
        total = jac_add(total, acc)
    return to_affine(total)


def decompress(b: bytes) -> Affine:
    """A 32-byte point encoding: x little-endian, bit 7 of the last byte the
    parity of y; all zero bytes for the identity.  Raises ValueError on a
    non-canonical x or an x that is not on the curve."""
    if len(b) != 32:
        raise ValueError("a point takes 32 bytes")
    sign = b[31] >> 7
    x = int.from_bytes(b[:31] + bytes([b[31] & 0x7F]), "little")
    if x >= Q:
        raise ValueError("non-canonical x")
    if x == 0 and sign == 0:
        return None
    rhs = (x * x * x + B) % Q
    y = pow(rhs, (Q + 1) // 4, Q)
    if y * y % Q != rhs:
        raise ValueError("x is not on the curve")
    if y & 1 != sign:
        y = Q - y
    return (x, y)
