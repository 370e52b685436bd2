"""secp256k1 — inventory-parity port of the reference's unused curve crate.

Mirrors the reference's arithmetic/curves/src/secp256k1/{fp.rs,fq.rs,curve.rs}
(755 LoC of macro-expanded Rust): the base/scalar fields, the y^2 = x^3 + 7
short-Weierstrass group, Jacobian arithmetic, scalar mul / naive MSM oracles,
Tonelli-Shanks sqrt, and compressed-point serde.  Like the reference, nothing
in the proving pipeline consumes it (SURVEY §2.1 "compiled, unused"); it
exists so a user of the reference crate finds the same surface here.

Device-side, the generic 16x16-bit-limb Montgomery kernels in fields/device
work for ANY 256-bit modulus, so secp Fp/Fq ride the same mont_mul/NTT-free
lane vectorization as BN254 — `FP_CTX`/`FQ_CTX` below plug straight into
fields.device.pack/mont_mul/unpack (pinned in tests/test_secp256k1.py).

The port's own copy of sha2cq_tpu/curves/secp256k1.py.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

# field moduli (fp.rs:27-48, fq.rs:27-48)
FP_MOD = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
FQ_MOD = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141

# curve.rs:37-50: generator and b = 7
GEN_X = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GEN_Y = 0x483ADA7726A3C465_5DA4FBFC0E1108A8_FD17B448A6855419_9C47D08FFB10D4B8
B = 7

Affine = Optional[Tuple[int, int]]      # None = identity
Jacobian = Tuple[int, int, int]         # Z = 0 = identity

JAC_IDENTITY: Jacobian = (0, 1, 0)
GENERATOR: Affine = (GEN_X, GEN_Y)


def is_on_curve(pt: Affine) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B) % FP_MOD == 0


def jac_from_affine(pt: Affine) -> Jacobian:
    if pt is None:
        return JAC_IDENTITY
    return (pt[0], pt[1], 1)


def jac_to_affine(pt: Jacobian) -> Affine:
    x, y, z = pt
    if z == 0:
        return None
    zi = pow(z, FP_MOD - 2, FP_MOD)
    zi2 = zi * zi % FP_MOD
    return (x * zi2 % FP_MOD, y * zi2 * zi % FP_MOD)


def jac_double(pt: Jacobian) -> Jacobian:
    """dbl-2009-l (a = 0), the formula family new_curve_impl expands to."""
    x, y, z = pt
    if z == 0 or y == 0:
        return JAC_IDENTITY
    p = FP_MOD
    a = x * x % p
    b = y * y % p
    c = b * b % p
    d = 2 * ((x + b) * (x + b) - a - c) % p
    e = 3 * a % p
    f = e * e % p
    x3 = (f - 2 * d) % p
    y3 = (e * (d - x3) - 8 * c) % p
    z3 = 2 * y * z % p
    return (x3, y3, z3)


def jac_add(p1: Jacobian, p2: Jacobian) -> Jacobian:
    if p1[2] == 0:
        return p2
    if p2[2] == 0:
        return p1
    p = FP_MOD
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    z1z1 = z1 * z1 % p
    z2z2 = z2 * z2 % p
    u1 = x1 * z2z2 % p
    u2 = x2 * z1z1 % p
    s1 = y1 * z2z2 * z2 % p
    s2 = y2 * z1z1 * z1 % p
    if u1 == u2:
        if s1 != s2:
            return JAC_IDENTITY
        return jac_double(p1)
    h = (u2 - u1) % p
    i = 4 * h * h % p
    j = h * i % p
    r = 2 * (s2 - s1) % p
    v = u1 * i % p
    x3 = (r * r - j - 2 * v) % p
    y3 = (r * (v - x3) - 2 * s1 * j) % p
    z3 = 2 * h * z1 * z2 % p
    return (x3, y3, z3)


def mul(pt: Affine, k: int) -> Affine:
    """Scalar multiplication (double-and-add; the reference derives it from
    the generic group macros — no GLV endomorphism: curve.rs:16-18 leaves
    endomorphism_base unimplemented)."""
    acc = JAC_IDENTITY
    base = jac_from_affine(pt)
    for bit in bin(k % FQ_MOD)[2:]:
        acc = jac_double(acc)
        if bit == "1":
            acc = jac_add(acc, base)
    return jac_to_affine(acc)


def msm(scalars: Sequence[int], points: Sequence[Affine]) -> Affine:
    acc = JAC_IDENTITY
    for s, pt in zip(scalars, points):
        acc = jac_add(acc, jac_from_affine(mul(pt, s)))
    return jac_to_affine(acc)


def neg(pt: Affine) -> Affine:
    if pt is None:
        return None
    return (pt[0], (-pt[1]) % FP_MOD)


def fp_sqrt(a: int) -> Optional[int]:
    """p ≡ 3 (mod 4): sqrt = a^((p+1)/4) (fp.rs sqrt impl shortcut)."""
    r = pow(a, (FP_MOD + 1) // 4, FP_MOD)
    return r if r * r % FP_MOD == a % FP_MOD else None


# fq.rs:75-116: Fq has 2-adicity s = 6, generator 7
FQ_S = 6
FQ_GENERATOR = 7
FQ_ROOT_OF_UNITY = pow(FQ_GENERATOR, (FQ_MOD - 1) >> FQ_S, FQ_MOD)


def fq_sqrt(a: int) -> Optional[int]:
    """Tonelli-Shanks for the scalar field (2-adicity 6)."""
    a %= FQ_MOD
    if a == 0:
        return 0
    if pow(a, (FQ_MOD - 1) // 2, FQ_MOD) != 1:
        return None
    q = (FQ_MOD - 1) >> FQ_S
    z = FQ_ROOT_OF_UNITY
    m, c, t, r = FQ_S, z, pow(a, q, FQ_MOD), pow(a, (q + 1) // 2, FQ_MOD)
    while t != 1:
        t2, i = t, 0
        while t2 != 1:
            t2 = t2 * t2 % FQ_MOD
            i += 1
        b = pow(c, 1 << (m - i - 1), FQ_MOD)
        m, c = i, b * b % FQ_MOD
        t = t * c % FQ_MOD
        r = r * b % FQ_MOD
    return r


# ---------------------------- serde (curve.rs GroupEncoding) ----------------

def to_bytes(pt: Affine) -> bytes:
    """33-byte compressed encoding: little-endian x + y-sign byte.  secp's
    p fills all 256 bits (unlike BN254), so there is no spare top bit — the
    upstream crate likewise widens secp compressed points past 32 bytes."""
    if pt is None:
        return bytes(33)
    x, y = pt
    return x.to_bytes(32, "little") + bytes([y & 1])


def from_bytes(b: bytes) -> Optional[Affine]:
    if len(b) != 33:
        raise ValueError("expected 33 bytes")
    if b == bytes(33):
        return None
    sign = b[32]
    if sign not in (0, 1):
        raise ValueError("non-canonical sign byte")
    x = int.from_bytes(b[:32], "little")
    if x >= FP_MOD:
        raise ValueError("x out of range")
    y = fp_sqrt((x * x * x + B) % FP_MOD)
    if y is None:
        raise ValueError("not on curve")
    if y & 1 != sign:
        y = FP_MOD - y
    return (x, y)


# ---------------------------- device contexts -------------------------------

def device_ctxs():
    """16x16-bit-limb Montgomery contexts of the device fields (wide: p >
    2^255, so a CUDA tensor takes kernel K1w; lazy: the fields.device
    import pulls in torch)."""
    from ..fields.device import FieldCtx
    return FieldCtx.make(FP_MOD, "SecpFp"), FieldCtx.make(FQ_MOD, "SecpFq")
